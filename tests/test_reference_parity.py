"""Reference-golden equivalence: run the ACTUAL upstream code side-by-side.

Everything else in the suite validates the rebuild against re-implemented
cases, ported doctests, and analytic rates. These tests instead import the
reference sources from /root/reference (read-only; bytecode writes disabled)
and compare, in float64 on CPU:

  * pypic.particle_push_p (pypic.py:216-300) vs engines.implicit's composed
    backend over a multi-step Landau-style run — trajectories, fields and
    fixed Picard iteration counts;
  * the L1 grid kernels (interpolate_p / weight_*_p / smooth_field_p /
    differentiate_p) vs ops.cic / ops.fd one call at a time;
  * pygcpic.Grid.solve_for_phi_dirichlet_boltzmann (pygcpic.py:1005-1053)
    vs ops.poisson.solve_boltzmann_dirichlet on identical rho, and the
    dirichlet-neumann variant (pygcpic.py:1062-1108) likewise;
  * the pic_iead step cycle (pygcpic.py:1200-1264: Boltzmann weighting with
    the adaptive-n0 recurrence, Newton solve, E differentiation, the
    swapped-weight Dirichlet gather, Boris push, wall BCs) vs
    engines.magnetized over several steps on a wall-free population (no
    RNG fires on either side, so the comparison is deterministic).

The reference needs numba only as a decorator; a stub that returns the
undecorated (plain numpy) functions makes it runnable in this image.
"""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _reference_harness import REF, load_reference


@pytest.fixture(scope="module")
def ref():
    """Import the reference modules with numba stubbed and matplotlib on
    Agg. Returns (pypic, pygcpic)."""
    return load_reference()


# ---------------------------------------------------------------------------
# L1 grid kernels, one call at a time
# ---------------------------------------------------------------------------


def test_grid_kernels_match_reference(ref):
    """gather / deposit / smooth / derivative vs the reference's numpy
    kernels on random f64 inputs (pypic.py:28-214)."""
    ref_pypic, _ = ref
    from pypic_tpu.ops import cic, fd

    rng = np.random.default_rng(3)
    ng, n = 37, 2000
    L = 1.7
    dx = L / ng
    x = rng.uniform(0.0, L - 1e-9, n)
    q = np.full(n, -1.602e-19)
    v = rng.normal(0.0, 1.0, n)
    F = rng.normal(0.0, 1.0, ng)
    p2c = 1e7

    # interpolate_p gathers from a periodic field at x
    got = np.asarray(cic.gather(jnp.asarray(F), jnp.asarray(x / dx),
                                periodic=True), np.float64)
    want = ref_pypic.interpolate_p(F, x, ng, n, dx)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)

    # weight_density_p == deposit of q p2c / dx
    got = np.asarray(
        cic.deposit(jnp.asarray(x / dx), jnp.asarray(q * p2c / dx), ng,
                    periodic=True), np.float64)
    want = ref_pypic.weight_density_p(x, q, p2c, ng, n, dx)
    np.testing.assert_allclose(got, want, rtol=1e-12)

    # weight_current_p == deposit of q v p2c / dx
    got = np.asarray(
        cic.deposit(jnp.asarray(x / dx), jnp.asarray(q * v * p2c / dx), ng,
                    periodic=True), np.float64)
    want = ref_pypic.weight_current_p(x, q, v, p2c, ng, n, dx)
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-18)

    # binomial smoother and centered periodic derivative
    np.testing.assert_allclose(
        np.asarray(fd.smooth_periodic(jnp.asarray(F)), np.float64),
        ref_pypic.smooth_field_p(F), rtol=1e-15)
    np.testing.assert_allclose(
        np.asarray(fd.grad_periodic(jnp.asarray(F), dx), np.float64),
        ref_pypic.differentiate_p(F, dx, ng), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# Implicit CN-Picard engine vs pypic.particle_push_p
# ---------------------------------------------------------------------------


def test_implicit_engine_matches_reference_particle_push(ref):
    """200 steps of the composed implicit step vs the reference pusher
    (pypic.py:216-300) from an identical f64 state.

    Both sides run a FIXED Picard count (tol=1e-30, maxiter=5) so the exit
    criterion can't diverge on last-ulp residual differences; remaining
    deviations are pure fp reassociation (ours works in grid coordinates)
    and grow slowly on this stable Landau workload."""
    ref_pypic, _ = ref
    from pypic_tpu.constants import (
        E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON,
    )
    from pypic_tpu.engines import implicit
    from pypic_tpu.grid import GridSpec

    rng = np.random.default_rng(11)
    ng, n, steps = 64, 4096, 200
    density, te = 1e10, 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    L = 20.0 * debye
    dx = L / ng
    p2c = L * density / n
    wp = np.sqrt(density * E_CHARGE**2 / (M_ELECTRON * EPSILON_0))
    dt = 0.1 / wp
    tol, maxiter = 1e-30, 5

    x0 = rng.uniform(0.0, L, n)
    # mild sinusoidal density perturbation as a displacement
    k1 = 2.0 * np.pi / L
    x0 = (x0 + 0.05 / k1 * np.sin(k1 * x0)) % L
    v0 = rng.normal(0.0, np.sqrt(K_BOLTZMANN * te / M_ELECTRON), n)
    q = np.full(n, -E_CHARGE)
    m = np.full(n, M_ELECTRON)

    # reference initial field chain (pypic.py:549-554)
    rho0 = ref_pypic.weight_density_p(x0, q, p2c, ng, n, dx)
    j0 = ref_pypic.weight_current_p(x0, q, v0, p2c, ng, n, dx)
    phi0 = ref_pypic.solve_poisson_p(dx, ng, rho0, np.zeros(ng))
    phi0 = phi0 - np.max(phi0)
    E0 = -ref_pypic.differentiate_p(phi0, dx, ng)

    grid = GridSpec(ng, L, "periodic")
    cfg = implicit.ImplicitConfig(
        grid, dt, p2c, tol=tol, maxiter=maxiter, backend="composed",
        picard_init="field", picard_accel="none",
    )
    f64 = jnp.float64
    st = implicit.ImplicitState(
        p=jnp.asarray(x0 / dx, f64), v=jnp.asarray(v0, f64),
        q=jnp.asarray(q, f64), m=jnp.asarray(m, f64),
        e=jnp.asarray(E0, f64), j=jnp.asarray(j0, f64),
        e_prev=jnp.asarray(E0, f64), e_prev2=jnp.asarray(E0, f64),
        step=jnp.asarray(0, jnp.int32),
    )
    step = jax.jit(implicit.make_step(cfg))

    xr, vr, Er, jr = x0, v0, E0, j0
    iters = []
    for _ in range(steps):
        xr, vr, Er, jr = ref_pypic.particle_push_p(
            xr, vr, q, m, Er, jr, n, ng, p2c, dx, dt, L, tol, maxiter)
        st, mtr = step(st)
        iters.append(int(mtr.picard_iters))

    assert iters == [maxiter] * steps  # fixed count on our side too

    e_ours = np.asarray(st.e, np.float64)
    v_ours = np.asarray(st.v, np.float64)
    x_ours = np.asarray(st.p, np.float64) * dx
    e_scale = np.max(np.abs(Er))
    v_scale = np.sqrt(K_BOLTZMANN * te / M_ELECTRON)
    # measured deviation after 200 steps: E ~1e-10 of scale, v ~1e-10 of
    # vth, x ~1e-10 of L (fp reassociation growth); assert 100x margins
    np.testing.assert_allclose(e_ours, Er, atol=1e-7 * e_scale, rtol=0)
    np.testing.assert_allclose(v_ours, vr, atol=1e-7 * v_scale, rtol=0)
    # positions compare modulo the periodic wrap
    dxp = np.abs(x_ours - xr)
    dxp = np.minimum(dxp, L - dxp)
    np.testing.assert_array_less(dxp, 1e-7 * L)


# ---------------------------------------------------------------------------
# Newton-Boltzmann field solve vs pygcpic.Grid
# ---------------------------------------------------------------------------


def test_boltzmann_dirichlet_solver_matches_reference(ref):
    """solve_boltzmann_dirichlet vs Grid.solve_for_phi_dirichlet_boltzmann
    (pygcpic.py:1005-1053) on identical rho: different Newton inner solvers
    (our direct tridiagonal vs the reference's warm-started bicgstab), same
    converged potential."""
    _, ref_gc = ref
    from pypic_tpu.ops.poisson import solve_boltzmann_dirichlet

    rng = np.random.default_rng(5)
    ng = 65
    te = 10.0 * 11600.0
    density = 1e16
    debye = np.sqrt(1.38e-23 * te * 8.854e-12 / 1.602e-19**2 / density)
    L = 100.0 * debye

    grid = ref_gc.Grid(ng, L, te)
    prof = 1.0 + 0.3 * np.sin(np.linspace(0.0, np.pi, ng)) \
        + 0.05 * rng.normal(size=ng)
    rho = 1.602e-19 * density * prof
    grid.n0 = 0.9 * density
    grid.rho[:] = rho
    grid.solve_for_phi_dirichlet_boltzmann()

    res = solve_boltzmann_dirichlet(
        jnp.asarray(rho, jnp.float64), 0.9 * density, te, grid.dx)
    phi_ours = np.asarray(res.phi, np.float64)
    scale = np.max(np.abs(grid.phi))
    assert scale > 1.0  # the workload actually produces a sheath-scale phi
    np.testing.assert_allclose(phi_ours, grid.phi, atol=1e-6 * scale, rtol=0)


def test_boltzmann_dirichlet_neumann_solver_matches_reference(ref):
    """solve_boltzmann_dirichlet_neumann vs
    Grid.solve_for_phi_dirichlet_neumann_boltzmann (pygcpic.py:1062-1108)
    on identical number density: both warm-start the whole Newton at the
    previous phi (the reference's own semantics for this variant)."""
    _, ref_gc = ref
    from pypic_tpu.ops.poisson import solve_boltzmann_dirichlet_neumann

    rng = np.random.default_rng(9)
    ng = 65
    te = 10.0 * 11600.0
    density = 1e16
    debye = np.sqrt(1.38e-23 * te * 8.854e-12 / 1.602e-19**2 / density)
    L = 100.0 * debye

    grid = ref_gc.Grid(ng, L, te, bc="dirichlet-neumann")
    prof = 1.0 + 0.3 * np.sin(np.linspace(0.0, np.pi, ng)) \
        + 0.05 * rng.normal(size=ng)
    grid.n0 = 0.9 * density
    grid.n[:] = density * prof
    grid.phi[:] = 0.0
    grid.solve_for_phi_dirichlet_neumann_boltzmann()

    res = solve_boltzmann_dirichlet_neumann(
        jnp.asarray(density * prof, jnp.float64), 0.9 * density, te,
        grid.dx, jnp.zeros((ng,), jnp.float64))
    phi_ours = np.asarray(res.phi, np.float64)
    scale = np.max(np.abs(grid.phi))
    assert scale > 1.0
    # this variant's Newton stops at |dphi| < 1e-3 (pygcpic.py:1080), so
    # the two implementations can legitimately sit ~1e-3 V apart
    np.testing.assert_allclose(phi_ours, grid.phi, atol=1e-2, rtol=0)


def test_explicit_push_matches_reference_pic_l(ref):
    """One explicit step vs PIC_L.py's pushParticlesExplicit
    (PIC_L.py:248-259): both half-kicks use E at the OLD position (the
    gathered field is never re-evaluated at the drifted position), i.e.
    v1 = v + qm dt E(x0), x1 = x0 + (v + qm dt/2 E(x0)) dt — the exact
    integrator form our explicit engine reproduces, compared here on the
    reference's own (Ng+1)-entry duplicated-node periodic field layout
    (PIC_L.py:100-117: arrays carry node Ng == node 0). The gen-1 main's
    full cycle is not driven side-by-side: its % (L+dx) wrap can index
    rho[Ng+1] out of bounds (a catalogued known-broken path)."""
    sys.path.insert(0, REF)
    try:
        import PIC_L as ref_l
    finally:
        sys.path.remove(REF)
    from pypic_tpu.ops import cic
    from pypic_tpu.push import leapfrog_push

    rng = np.random.default_rng(17)
    ng, n = 64, 3000
    dx = 0.04
    dt = 1e-8
    me, qe = 9.11e-31, -1.602e-19
    F = rng.normal(0.0, 50.0, ng)
    F_ref = np.concatenate([F, F[:1]])  # duplicated-node layout (Ng+1)
    # interior band: no wrap ambiguity in the single compared step
    x = rng.uniform(2.0 * dx, (ng - 2.0) * dx, n)
    v = rng.normal(0.0, 4e5, n)
    q = np.full(n, qe)
    m = np.full(n, me)

    x1_ref, v1_ref = ref_l.pushParticlesExplicit(
        x.copy(), v.copy(), q, m, n, ng, dt, dx, F_ref)

    e_p = cic.gather(jnp.asarray(F), jnp.asarray(x / dx), periodic=True)
    p1, v1 = leapfrog_push(jnp.asarray(x / dx), jnp.asarray(v), e_p,
                           jnp.asarray(q / m), dt, dt / dx)
    np.testing.assert_allclose(np.asarray(v1, np.float64), v1_ref,
                               rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(np.asarray(p1, np.float64) * dx, x1_ref,
                               rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# gen-2 bounded sheath (PIC_L_DD.py main_i) vs engines.sheath
# ---------------------------------------------------------------------------


def test_sheath_engine_matches_reference_main_i_cycle(ref):
    """Side-by-side f64 run of the gen-2 sheath CN-Picard cycle: the
    reference loop is driven here exactly as main_i drives it
    (PIC_L_DD.py:455-545 — interpolateField gather at xs, CN push,
    mid-Picard wall absorption on (x0, xh, x1), weightCurrents with the
    wall surface-charge terms, the unsmoothed Ampere advance, r =
    ||Es - Eh||_2) against engines.sheath's composed backend.

    Determinism: gamma = 0 (the thermostat never triggers) and the
    comparison stops at the first step that absorbs a particle — the
    reference re-initializes lost rows with np.random draws at the TOP of
    the next step (PIC_L_DD.py:430-450), which our engine replaces with
    its own RNG streams, so later steps are distribution-equal but not
    trajectory-equal. Planted wall-bound ions guarantee the absorption
    (and with it the wall surface-charge deposit path) happens inside the
    compared window."""
    ref_pypic, _ = ref  # ensures the stubbed import environment is set up
    sys.path.insert(0, REF)
    try:
        import PIC_L_DD as ref_dd
    finally:
        sys.path.remove(REF)

    from pypic_tpu.constants import K_BOLTZMANN
    from pypic_tpu.engines import sheath
    from pypic_tpu.grid import GridSpec

    rng = np.random.default_rng(13)
    ng, n = 51, 4096
    dx = 1e-5
    L = dx * (ng - 1)
    dt = 1e-12
    te = ti = 10.0 * 11600.0
    density = 1e19
    p2c = density * L / n
    tol, maxiter = 1e-5, 10

    me = 9.11e-31
    mi = 1.67e-27
    half = n // 2
    m = np.concatenate([np.full(half, mi), np.full(n - half, me)])
    q = np.concatenate([np.full(half, 1.602e-19),
                        np.full(n - half, -1.602e-19)])
    species = np.concatenate([np.full(half, 2, np.int32),
                              np.full(n - half, 1, np.int32)])
    x0 = rng.uniform(0.08 * L, 0.92 * L, n)
    kbt = np.where(species == 1, K_BOLTZMANN * te, K_BOLTZMANN * ti)
    u0 = rng.normal(0.0, np.sqrt(kbt / m))
    v0 = rng.normal(0.0, np.sqrt(kbt / m))
    w0 = rng.normal(0.0, np.sqrt(kbt / m))
    # plant four wall-bound ions (~0.5 dx/step towards the left wall)
    x0[:4] = 0.6 * dx
    u0[:4] = -5e6

    # --- our engine: f64 state with the reference's zero initial field
    grid = GridSpec(ng, L, "dirichlet-dirichlet")
    cfg = sheath.SheathConfig(
        grid, dt, p2c, kbte=K_BOLTZMANN * te, kbti=K_BOLTZMANN * ti,
        tol=tol, maxiter=maxiter, gamma=0.0, tol_floor=0.0,
        picard_init="field", picard_accel="none",
    )
    v3 = np.stack([u0, v0, w0], axis=-1)
    st = sheath.init_state(x0, v3, q, m, species, cfg, dtype=jnp.float64)
    st = st.replace(e=jnp.zeros((ng,), jnp.float64))
    step = jax.jit(sheath.make_step(cfg))

    # --- reference loop state
    xr, ur, vr, wr = x0.copy(), u0.copy(), v0.copy(), w0.copy()
    Er = np.zeros(ng)
    active = np.ones(n, np.int64)

    def ref_step(xr, ur, vr, wr, Er, active):
        """One main_i step body (PIC_L_DD.py:455-545), RNG-free paths."""
        Es, xs = Er, xr
        r, k = 1.0, 0
        while (r > tol) and (k < maxiter):
            E_interp = np.zeros(n)
            for i in range(n):
                if active[i] == 1:
                    E_interp[i] = ref_dd.interpolateField(Es, xs[i], ng, dx)
            x1 = np.zeros(n)
            u1 = np.zeros(n)
            xh = np.zeros(n)
            uh = np.zeros(n)
            act = active == 1
            x1[act] = (xr[act] + dt * ur[act]
                       + dt * dt * (q[act] / m[act]) * E_interp[act] * 0.5)
            u1[act] = ur[act] + dt * (q[act] / m[act]) * E_interp[act]
            xh[act] = 0.5 * (xr[act] + x1[act])
            uh[act] = 0.5 * (ur[act] + u1[act])
            hit_r = act & ((xr >= L) | (xh >= L) | (x1 >= L))
            active[hit_r] = 0
            hit_l = (active == 1) & ((xr <= 0.0) | (xh <= 0.0)
                                     | (x1 <= 0.0))
            active[hit_l] = -1
            jh = ref_dd.weightCurrents(xh, q, uh, p2c, ng, n, dx, dt,
                                       active)
            j1 = ref_dd.weightCurrents(x1, q, u1, p2c, ng, n, dx, dt,
                                       active)
            E1 = Er + (dt / ref_dd.epsilon0) * (np.average(jh) - jh)
            Eh = 0.5 * (E1 + Er)
            r = np.linalg.norm(Es - Eh)
            Es, xs = Eh, xh
            k += 1
        return x1, u1, E1, active, k

    for t in range(8):
        xr, ur, Er, active, k_ref = ref_step(xr, ur, vr, wr, Er, active)
        st, mtr = step(st)
        n_lost = int(np.sum(active != 1))
        n_lost_ours = int(mtr.n_lost_left) + int(mtr.n_lost_right)
        assert n_lost_ours == n_lost, (t, n_lost_ours, n_lost)
        assert int(mtr.picard_iters) == k_ref, (t, int(mtr.picard_iters),
                                                k_ref)
        e_ours = np.asarray(st.e, np.float64)
        e_scale = max(np.max(np.abs(Er)), 1.0)
        np.testing.assert_allclose(e_ours, Er, atol=1e-9 * e_scale, rtol=0,
                                   err_msg=f"E mismatch at step {t}")
        act = active == 1
        x_ours = np.asarray(st.p, np.float64) * dx
        u_ours = np.asarray(st.u, np.float64)
        np.testing.assert_allclose(x_ours[act], xr[act], atol=1e-9 * L,
                                   rtol=0, err_msg=f"x mismatch at step {t}")
        u_scale = float(np.sqrt(K_BOLTZMANN * te / me))
        np.testing.assert_allclose(u_ours[act], ur[act],
                                   atol=1e-9 * u_scale, rtol=0,
                                   err_msg=f"u mismatch at step {t}")
        if n_lost > 0:
            # wall path exercised; the reference re-injects these rows
            # with np.random at the top of the NEXT step — stop here
            break
    assert n_lost > 0, "no absorption happened — the wall path went untested"


# ---------------------------------------------------------------------------
# pic_iead step cycle vs engines.magnetized
# ---------------------------------------------------------------------------


def test_magnetized_cycle_matches_reference_pic_iead_body(ref):
    """Five pic_iead step cycles (pygcpic.py:1214-1244) vs the magnetized
    engine: Boltzmann weighting incl. the adaptive-n0 recurrence and its
    eta = exp(phi/Te/11600) quirk (pygcpic.py:889-904), the Newton solve,
    differentiate_phi_to_E_dirichlet, the SWAPPED-weight Dirichlet field
    gather (pygcpic.py:343-347), Boris push_6D (pygcpic.py:460-507) and the
    Dirichlet wall BCs. The population starts mid-domain with thermal
    velocities so nothing reaches a wall and no reactivation RNG fires on
    either side."""
    _, ref_gc = ref
    from pypic_tpu.engines import magnetized
    from pypic_tpu.grid import GridSpec

    rng = np.random.default_rng(7)
    ng, n, steps = 64, 256, 5
    te = ti = 10.0 * 11600.0
    density = 1e16
    debye = np.sqrt(1.38e-23 * te * 8.854e-12 / 1.602e-19**2 / density)
    L = 100.0 * debye
    dt = 1e-10
    p2c = density * L / n
    mass = 2.0 * 1.67e-27  # deuterium, reference mp
    alpha = 86.0 * np.pi / 180.0
    B0 = np.array([2.0 * np.cos(alpha), 2.0 * np.sin(alpha), 0.0])

    x0 = rng.uniform(0.4 * L, 0.6 * L, n)
    vth = np.sqrt(1.38e-23 * ti / mass)
    v0 = rng.normal(0.0, vth, (n, 3))

    # reference side: Grid + Particle list with deterministic overrides
    grid_ref = ref_gc.Grid(ng, L, te, bc="dirichlet-dirichlet")
    parts = []
    for i in range(n):
        pt = ref_gc.Particle(mass, 1, p2c, ti, Z=1, B0=B0.copy(),
                             E0=np.zeros(3), grid=grid_ref)
        pt.r[:] = 0.0
        pt.r[0] = x0[i]
        pt.r[3:6] = v0[i]
        parts.append(pt)

    # our side: f64 state
    cfg = magnetized.MagnetizedConfig(
        grid=GridSpec(ng, L, "dirichlet-dirichlet"), dt=dt, te=te,
        b=tuple(B0), species_z=(1,), reactivate="none",
        newton_tol=1e-9, newton_maxiter=1000,
    )
    st = magnetized.init_state(
        x0, v0, m=mass, charge_state=1.0, p2c=p2c, species_idx=0,
        cfg=cfg, dtype=jnp.float64,
    )
    step = jax.jit(magnetized.make_step(cfg))

    for t in range(steps):
        grid_ref.weight_particles_to_grid_boltzmann(parts, dt)
        grid_ref.reset_added_particles()
        grid_ref.solve_for_phi_dirichlet_boltzmann()
        grid_ref.differentiate_phi_to_E_dirichlet()
        for pt in parts:
            assert pt.is_active()
            pt.interpolate_electric_field_dirichlet(grid_ref)
            pt.push_6D(dt)
            pt.apply_BCs_dirichlet(grid_ref)

        st, mtr = step(st)
        assert int(mtr.n_hit_wall) == 0
        phi_scale = max(np.max(np.abs(grid_ref.phi)), 1.0)
        # both Newtons stop at |dphi|^2 < 1e-9, but the reference's inner
        # bicgstab (default rtol 1e-5) leaves O(1e-4) of self-error per
        # solve that random-walks through the rho feedback — measured
        # 1.4e-4 worst-node at step 1 growing to 1.4e-3 by step 4; assert
        # with ~4x margin (still 4 orders below the 63 V scale)
        np.testing.assert_allclose(
            np.asarray(mtr.phi, np.float64), grid_ref.phi,
            atol=1e-4 * phi_scale, rtol=0,
            err_msg=f"phi mismatch at step {t}")
        np.testing.assert_allclose(
            float(mtr.n0), grid_ref.n0, rtol=1e-9,
            err_msg=f"n0 mismatch at step {t}")

    x_ref = np.array([pt.r[0] for pt in parts])
    v_ref = np.array([pt.r[3:6] for pt in parts])
    x_ours = np.asarray(st.p, np.float64) * cfg.grid.dx  # dx = L/(ng-1)
    v_ours = np.stack(
        [np.asarray(st.vx, np.float64), np.asarray(st.vy, np.float64),
         np.asarray(st.vz, np.float64)], axis=-1)[:n]
    # solver-tolerance phi noise propagates into E and then v at the
    # ~1e-3 m/s/step level (vth ~ 2e4 m/s); assert well above that floor
    np.testing.assert_allclose(x_ours[:n], x_ref, atol=1e-8 * L, rtol=0)
    np.testing.assert_allclose(v_ours, v_ref, atol=1e-5 * vth, rtol=0)


def test_magnetized_dn_cycle_matches_reference(ref):
    """One dirichlet_neumann_test step cycle (pygcpic.py:2027-2045): the
    same body as the D-D cycle but solved with
    solve_for_phi_dirichlet_neumann_boltzmann (pygcpic.py:1062-1108 —
    whole-Newton warm start, number-density source, Sherman-Morrison
    rank-1 Neumann row on our side). Wall-free population, no RNG; see
    the in-test note on why the window is a single cold-start cycle."""
    _, ref_gc = ref
    from pypic_tpu.engines import magnetized
    from pypic_tpu.grid import GridSpec

    rng = np.random.default_rng(31)
    # ONE cycle: without the real driver's flux inflow (which is
    # RNG-driven) the D-N half-sheath is unstable on BOTH sides — phi
    # runs away within 2 steps and the runaway amplifies the two
    # implementations' tol-1e-3 solver differences without bound, so
    # only the cold-start cycle (weight + n0 seed + D-N Newton from the
    # zero warm start + E + push) compares meaningfully
    ng, n, steps = 64, 2048, 1
    te = ti = 10.0 * 11600.0
    density = 1e16
    debye = np.sqrt(1.38e-23 * te * 8.854e-12 / 1.602e-19**2 / density)
    L = 100.0 * debye
    dt = 1e-10
    p2c = density * L / n
    mass = 1.67e-27
    B0 = np.zeros(3)

    # full-domain fill (the real driver's shape): a mid-domain band
    # leaves ZERO wall density and the reference's D-N Newton runs away
    # (phi ~ 1e27 within two steps); interior margin keeps the compared
    # window wall-hit-free
    x0 = rng.uniform(0.03 * L, 0.97 * L, n)
    vth = np.sqrt(1.38e-23 * ti / mass)
    v0 = rng.normal(0.0, 0.3 * vth, (n, 3))

    grid_ref = ref_gc.Grid(ng, L, te, bc="dirichlet-neumann")
    parts = []
    for i in range(n):
        pt = ref_gc.Particle(mass, 1, p2c, ti, Z=1, B0=B0.copy(),
                             E0=np.zeros(3), grid=grid_ref)
        pt.r[:] = 0.0
        pt.r[0] = x0[i]
        pt.r[3:6] = v0[i]
        parts.append(pt)

    cfg = magnetized.MagnetizedConfig(
        grid=GridSpec(ng, L, "dirichlet-neumann"), dt=dt, te=te,
        b=tuple(B0), species_z=(1,), reactivate="none",
    )
    st = magnetized.init_state(
        x0, v0, m=mass, charge_state=1.0, p2c=p2c, species_idx=0,
        cfg=cfg, dtype=jnp.float64,
    )
    step = jax.jit(magnetized.make_step(cfg))

    for t in range(steps):
        grid_ref.weight_particles_to_grid_boltzmann(parts, dt)
        grid_ref.reset_added_particles()
        grid_ref.solve_for_phi_dirichlet_neumann_boltzmann()
        grid_ref.differentiate_phi_to_E_dirichlet()
        for pt in parts:
            assert pt.is_active()
            pt.interpolate_electric_field_dirichlet(grid_ref)
            pt.push_6D(dt)
            pt.apply_BCs_dirichlet(grid_ref)
        st, mtr = step(st)
        assert int(mtr.n_hit_wall) == 0
        phi_scale = max(np.max(np.abs(grid_ref.phi)), 1.0)
        # this variant's Newton stops at |dphi| < 1e-3 and the reference
        # inverts J densely while we take a Sherman-Morrison tridiag
        # step, so the converged answers sit ~1e-3 V apart per solve
        np.testing.assert_allclose(
            np.asarray(mtr.phi, np.float64), grid_ref.phi,
            atol=2e-2 * phi_scale, rtol=0,
            err_msg=f"phi mismatch at step {t}")
        np.testing.assert_allclose(
            float(mtr.n0), grid_ref.n0, rtol=1e-6,
            err_msg=f"n0 mismatch at step {t}")

    x_ref = np.array([pt.r[0] for pt in parts])
    x_ours = np.asarray(st.p, np.float64)[:n] * cfg.grid.dx
    np.testing.assert_allclose(x_ours, x_ref, atol=1e-6 * L, rtol=0)


def test_magnetized_iead_bins_match_reference_histogram2d(ref):
    """IEAD accumulation vs the reference's per-impact collection +
    np.histogram2d (pygcpic.py:1240-1262): planted wall-bound ions hit in
    step 1; the engine's per-step histogram deposit must reproduce the
    reference's kinetic_energy/get_angle_wrt_wall binning
    (pygcpic.py:228-275) bin-for-bin, including the range-discard
    semantics for an impact planted beyond energy_max."""
    _, ref_gc = ref
    from pypic_tpu.engines import magnetized
    from pypic_tpu.grid import GridSpec

    rng = np.random.default_rng(23)
    ng, n_bg = 64, 128
    te = ti = 10.0 * 11600.0
    density = 1e16
    debye = np.sqrt(1.38e-23 * te * 8.854e-12 / 1.602e-19**2 / density)
    L = 100.0 * debye
    dt = 1e-10
    mass = 2.0 * 1.67e-27
    B0 = np.array([0.5, 1.5, 0.0])
    e_max, a_max, bins = 120.0, 90.0, (12, 10)

    # background stays mid-domain; 9 planted rows hit the left wall in
    # step 1 with a spread of energies/angles (the last one beyond e_max
    # — discarded from the histograms on BOTH sides)
    x_bg = rng.uniform(0.45 * L, 0.55 * L, n_bg)
    v_bg = rng.normal(0.0, np.sqrt(1.38e-23 * ti / mass), (n_bg, 3))
    energies_ev = np.array([5.0, 12.0, 25.0, 40.0, 60.0, 80.0, 100.0,
                            115.0, 500.0])
    angles_deg = np.array([5.0, 15.0, 25.0, 35.0, 45.0, 55.0, 65.0,
                           80.0, 30.0])
    speeds = np.sqrt(2.0 * energies_ev * 1.602e-19 / mass)
    vx_p = -speeds * np.cos(np.radians(angles_deg))
    vyz = speeds * np.sin(np.radians(angles_deg))
    v_p = np.stack([vx_p, vyz / np.sqrt(2.0), vyz / np.sqrt(2.0)], -1)
    dx = L / (ng - 1)
    x_p = np.full(len(energies_ev), 1e-4 * dx)

    x0 = np.concatenate([x_p, x_bg])
    v0 = np.concatenate([v_p, v_bg])
    n = x0.shape[0]
    p2c = density * L / n

    # reference side
    grid_ref = ref_gc.Grid(ng, L, te, bc="dirichlet-dirichlet")
    parts = []
    for i in range(n):
        pt = ref_gc.Particle(mass, 1, p2c, ti, Z=1, B0=B0.copy(),
                             E0=np.zeros(3), grid=grid_ref)
        pt.r[:] = 0.0
        pt.r[0] = x0[i]
        pt.r[3:6] = v0[i]
        parts.append(pt)
    grid_ref.weight_particles_to_grid_boltzmann(parts, dt)
    grid_ref.reset_added_particles()
    grid_ref.solve_for_phi_dirichlet_boltzmann()
    grid_ref.differentiate_phi_to_E_dirichlet()
    energies, angles = [], []
    for pt in parts:
        pt.interpolate_electric_field_dirichlet(grid_ref)
        pt.push_6D(dt)
        pt.apply_BCs_dirichlet(grid_ref)
        if not pt.is_active():
            energies.append(pt.kinetic_energy / 1.602e-19)
            angles.append(pt.get_angle_wrt_wall())
    iead_ref, _, _ = np.histogram2d(
        energies, angles, bins=bins, range=[[0.0, e_max], [0.0, a_max]])

    # our side
    cfg = magnetized.MagnetizedConfig(
        grid=GridSpec(ng, L, "dirichlet-dirichlet"), dt=dt, te=te,
        b=tuple(B0), species_z=(1,), reactivate="none",
        iead_bins=bins, iead_energy_max=e_max, iead_angle_max=a_max,
    )
    st = magnetized.init_state(
        x0, v0, m=mass, charge_state=1.0, p2c=p2c, species_idx=0,
        cfg=cfg, dtype=jnp.float64,
    )
    st1, mtr = jax.jit(magnetized.make_step(cfg))(st)

    assert int(mtr.n_hit_wall) == len(energies) >= 9
    assert iead_ref.sum() == len(energies) - 1  # the 500 eV row discarded
    np.testing.assert_array_equal(np.asarray(st1.iead)[0], iead_ref)
