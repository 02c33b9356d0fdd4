"""Reference-golden equivalence for the RNG-DRIVEN lifecycle paths.

The deterministic golden harness (test_reference_parity.py) deliberately
halts before any randomness fires. These tests close that gap: both sides
replay ONE recorded random stream — genuine samples drawn once from a
seeded numpy Generator into per-(slot, purpose) tables — so the RNG-driven
dynamics themselves compare side-by-side in float64:

  * gen-2 thermal re-injection of absorbed rows + the Langevin thermostat
    (PIC_L_DD.py:420-450) THROUGH the steps the deterministic sheath test
    stops at. The reference consumes np.random per-particle; the tables
    stand in for those draws in the transcribed blocks, and the identical
    tables are fed to engines.sheath by monkeypatching jax.random.uniform /
    jax.random.normal (the engine's only RNG consumers on the threefry
    path) — the test-only sampler hook.
  * Particle.reactivate + the added-particle ledger credit
    (pygcpic.py:691-720, 1111-1117) driven through the ACTUAL
    Particle.reactivate method and the ACTUAL source_distribution_6D
    generator (np.random.normal monkeypatched to replay the stream), vs
    engines.magnetized with reactivate='source' fed the same stream
    through a monkeypatched sources.sample_source_6d. Includes the
    reference's one-weighting "limbo" timing (the else branch only
    reaches slots already inactive at loop start, pygcpic.py:1249-1254 —
    MagnetizedConfig.react_timing='reference').
  * one FORCED MCC ionization success (pygcpic.py:387-398; probability
    pinned >= 1, so the uniform decision is deterministic on both sides)
    and the grid.add_particles credit flowing through the adaptive-n0
    recurrence (pygcpic.py:889-904).

Plus the round-4 VERDICT's long-horizon item: a 120-step matched pic_iead
D-D run asserting the adaptive-n0 feedback tracks far beyond the
deterministic harness's 5-step window.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _reference_harness import load_reference, load_pic_l_dd


@pytest.fixture(scope="module")
def ref():
    return load_reference()


# ---------------------------------------------------------------------------
# gen-2 re-injection + thermostat (PIC_L_DD.py:420-450)
# ---------------------------------------------------------------------------


def test_sheath_reinjection_and_thermostat_match_reference(ref, monkeypatch):
    """12 side-by-side f64 steps of the gen-2 main_i cycle INCLUDING the
    RNG blocks: per-step, the reference order is thermostat
    (PIC_L_DD.py:420-427: prob-gamma resample of u,v,w to Ti for every
    species — the reference quirk of using kBTi for electrons too), then
    re-initialization of non-active rows (429-450: uniform position,
    per-species Maxwellian), then the CN-Picard field loop. Planted
    wall-bound ions guarantee absorption in an early step, so rows flow
    through LOST -> re-injected -> re-absorbed across the compared window
    — the exact channel the deterministic golden sheath test stops at.

    The random stream: per-step tables U_therm (n,), Z_therm (3,n),
    U_x (n,), Z_re (3,n) drawn once from a seeded Generator. The
    transcribed reference blocks read them per-slot; the engine receives
    them through monkeypatched jax.random.uniform/normal (its only RNG
    consumers on the threefry path: exactly 2 uniform + 2 normal calls
    per step, discriminated by their maxval/call order)."""
    ref_pypic, _ = ref  # stubbed import environment
    ref_dd = load_pic_l_dd()

    from pypic_tpu.constants import K_BOLTZMANN
    from pypic_tpu.engines import sheath
    from pypic_tpu.grid import GridSpec

    rng = np.random.default_rng(41)
    ng, n, steps = 51, 2048, 12
    dx = 1e-5
    L = dx * (ng - 1)
    dt = 1e-12
    te = ti = 10.0 * 11600.0
    density = 1e19
    p2c = density * L / n
    tol, maxiter = 1e-5, 10
    gamma = 0.4

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
    # plant wall-bound ions (~2 dx/step toward the left wall)
    x0[:4] = 1.5 * dx
    u0[:4] = -2e7

    # --- the recorded stream: one table set per step ---
    tab = []
    for s in range(steps):
        t = {
            "u_therm": rng.uniform(0.0, 1.0, n),
            "z_therm": rng.normal(0.0, 1.0, (3, n)),
            "u_x": rng.uniform(0.0, 1.0, n),
            "z_re": rng.normal(0.0, 1.0, (3, n)),
        }
        if s < 2:
            # the stream is ours to record: keep the planted rows' early
            # thermostat decisions above gamma so the resample can't kill
            # their inbound velocity before the absorption under test
            t["u_therm"][:4] = 0.999
        tab.append(t)

    # --- our engine, fed the tables through the jax.random hook ---
    grid = GridSpec(ng, L, "dirichlet-dirichlet")
    cfg = sheath.SheathConfig(
        grid, dt, p2c, kbte=K_BOLTZMANN * te, kbti=K_BOLTZMANN * ti,
        tol=tol, maxiter=maxiter, gamma=gamma, tol_floor=0.0,
        picard_init="field", picard_accel="none",
        rng_sampler="threefry",
    )
    v3 = np.stack([u0, v0, w0], axis=-1)
    st = sheath.init_state(x0, v3, q, m, species, cfg, dtype=jnp.float64)
    st = st.replace(e=jnp.zeros((ng,), jnp.float64))
    step = sheath.make_step(cfg)  # UNJITTED: the hook returns fresh
    # per-step constants, which a traced step would bake in

    cur = {"s": 0, "normals": 0}
    cells = float(grid.num_cells)

    def fake_uniform(key, shape=(), dtype=float, minval=0.0, maxval=1.0):
        t = tab[cur["s"]]
        if float(maxval) == 1.0:  # thermostat decision draw
            return jnp.asarray(t["u_therm"], jnp.float64)
        assert float(maxval) == cells  # re-injection position draw
        return jnp.asarray(t["u_x"] * cells, jnp.float64)

    def fake_normal(key, shape=(), dtype=float):
        t = tab[cur["s"]]
        assert tuple(shape) == (3, n)
        z = t["z_therm"] if cur["normals"] == 0 else t["z_re"]
        cur["normals"] += 1
        if cur["normals"] == 2:  # last RNG consumer of the step
            cur["normals"] = 0
            cur["s"] += 1
        return jnp.asarray(z, jnp.float64)

    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(jax.random, "normal", fake_normal)

    # --- reference loop state ---
    xr, ur, vr, wr = x0.copy(), u0.copy(), v0.copy(), w0.copy()
    Er = np.zeros(ng)
    active = np.ones(n, np.int64)

    def ref_picard(xr, ur, Er, active):
        """One main_i CN-Picard body (PIC_L_DD.py:455-545)."""
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
            E1 = Er + (dt / ref_dd.epsilon0) * (np.average(jh) - jh)
            Eh = 0.5 * (E1 + Er)
            r = np.linalg.norm(Es - Eh)
            Es, xs = Eh, xh
            k += 1
        return x1, u1, E1, active, k

    total_reinjected = 0
    for t in range(steps):
        T = tab[t]
        # Thermostat (PIC_L_DD.py:420-427): per ACTIVE particle, one
        # uniform decision; on success u,v,w resample at sqrt(kBTi/m)
        # for every species (reference quirk)
        for i in range(n):
            if active[i] == 1 and T["u_therm"][i] < gamma:
                sig = np.sqrt(K_BOLTZMANN * ti / m[i])
                ur[i] = T["z_therm"][0, i] * sig
                vr[i] = T["z_therm"][1, i] * sig
                wr[i] = T["z_therm"][2, i] * sig
        # Re-initialization (PIC_L_DD.py:429-450): per NON-active row,
        # uniform position + per-species Maxwellian (ions kBTi,
        # electrons kBTe)
        for i in range(n):
            if active[i] != 1:
                total_reinjected += 1
                kbt_i = K_BOLTZMANN * (ti if species[i] == 2 else te)
                sig = np.sqrt(kbt_i / m[i])
                xr[i] = T["u_x"][i] * L
                ur[i] = T["z_re"][0, i] * sig
                vr[i] = T["z_re"][1, i] * sig
                wr[i] = T["z_re"][2, i] * sig
                active[i] = 1
        xr, ur, Er, active, k_ref = ref_picard(xr, ur, Er, active)

        st, mtr = step(st)
        n_lost = int(np.sum(active != 1))
        assert int(mtr.n_lost_left) + int(mtr.n_lost_right) == n_lost, t
        assert int(mtr.picard_iters) == k_ref, (t, int(mtr.picard_iters),
                                                k_ref)
        e_ours = np.asarray(st.e, np.float64)
        e_scale = max(np.max(np.abs(Er)), 1.0)
        np.testing.assert_allclose(e_ours, Er, atol=1e-9 * e_scale, rtol=0,
                                   err_msg=f"E mismatch at step {t}")
        act = active == 1
        np.testing.assert_allclose(
            np.asarray(st.p, np.float64)[act] * dx, xr[act],
            atol=1e-9 * L, rtol=0, err_msg=f"x mismatch at step {t}")
        u_scale = float(np.sqrt(K_BOLTZMANN * te / me))
        np.testing.assert_allclose(
            np.asarray(st.u, np.float64)[act], ur[act],
            atol=1e-9 * u_scale, rtol=0, err_msg=f"u mismatch at step {t}")
        # the thermostat-resampled transverse velocities too
        np.testing.assert_allclose(
            np.asarray(st.vy, np.float64)[act], vr[act],
            atol=1e-9 * u_scale, rtol=0, err_msg=f"vy mismatch at step {t}")
    assert total_reinjected >= 4, "no re-injection fired — dead test"


# ---------------------------------------------------------------------------
# Particle.reactivate + ledger credit (pygcpic.py:691-720, 1111-1117)
# ---------------------------------------------------------------------------


def test_magnetized_reactivate_and_ledger_match_reference(ref, monkeypatch):
    """8 pic_iead/pic_bca_aps-style D-D cycles where planted wall-bound
    ions are absorbed and then re-enter through the ACTUAL
    Particle.reactivate + source_distribution_6D (pygcpic.py:691-720,
    723-755; np.random.normal monkeypatched to replay the recorded
    stream). Our engine consumes the identical stream through a
    monkeypatched sources.sample_source_6d. Covers the reference timing
    (one-weighting limbo — react_timing='reference'), the add_particles
    ledger credit (pygcpic.py:716-717, 1115-1117) and its consumption by
    the adaptive-n0 recurrence one weighting later (pygcpic.py:900-902).

    The reactivate arguments follow the pic_bca_aps call
    (pygcpic.py:1545: charge_state=1); pic_iead's own call passes
    charge_state=1.*e — a catalogued reference slip that would make
    re-activated ions effectively neutral (PARITY.md)."""
    _, ref_gc = ref
    from pypic_tpu import sources
    from pypic_tpu.engines import magnetized
    from pypic_tpu.grid import GridSpec

    rng = np.random.default_rng(53)
    ng, n, steps = 64, 192, 8
    te = ti = 10.0 * 11600.0
    density = 1e16
    debye = np.sqrt(1.38e-23 * te * 8.854e-12 / 1.602e-19**2 / density)
    L = 100.0 * debye
    dt = 1e-10
    p2c = density * L / n
    mass = 2.0 * 1.67e-27
    alpha = 86.0 * np.pi / 180.0
    B0 = np.array([2.0 * np.cos(alpha), 2.0 * np.sin(alpha), 0.0])
    dx = L / (ng - 1)

    x0 = rng.uniform(0.4 * L, 0.6 * L, n)
    vth = np.sqrt(1.38e-23 * ti / mass)
    v0 = rng.normal(0.0, vth, (n, 3))
    # planted wall-bound ions at scattered slots: cross the left wall in
    # step 1 (0.27 dx/step inbound from 0.2 dx), reactivate (reference
    # timing) at the END of step 2's loop
    planted = np.array([3, 40, 77, 118, 160])
    x0[planted] = 0.2 * dx
    v0[planted, 0] = -1e6

    # --- the recorded stream, in re-activation event order ---
    max_events = 64
    X_raw = rng.normal(L / 2.0, L / 12.0, max_events) % L
    Z_v = rng.normal(0.0, 1.0, (max_events, 3))

    # --- reference side: actual Particle.reactivate + actual generator ---
    grid_ref = ref_gc.Grid(ng, L, te, bc="dirichlet-dirichlet")
    parts = []
    for i in range(n):
        pt = ref_gc.Particle(mass, 1, p2c, ti, Z=1, B0=B0.copy(),
                             E0=np.zeros(3), grid=grid_ref)
        pt.r[:] = 0.0
        pt.r[0] = x0[i]
        pt.r[3:6] = v0[i]
        parts.append(pt)
    source_distribution = ref_gc.source_distribution_6D(grid_ref, ti, mass)

    ev = {"i": 0}

    def fake_np_normal(loc=0.0, scale=1.0, size=None):
        """Replay shim for source_distribution_6D's two draws
        (pygcpic.py:748-751): the x draw (scalar, mu=L/2) and the
        3-velocity draw (size=3, mu=0)."""
        if size == 3:
            return Z_v[ev["i"] - 1] * scale  # x drawn first: same event
        assert size is None and loc == grid_ref.length / 2.0
        x = X_raw[ev["i"]]
        ev["i"] += 1
        return x  # already wrapped into [0, L)

    monkeypatch.setattr(np.random, "normal", fake_np_normal)

    # --- our side: the identical stream through the sampler hook ---
    def fake_sample_source(key, n_draw, grid_s, ti_s, mass_s, vx=0.0,
                           components=True):
        """Full-capacity batch (react_batch=0: slot i consumes row i).
        Rows for the slots that will re-activate this step carry the
        recorded events in slot order — the same order the reference's
        particle loop consumes the generator."""
        assert n_draw == n
        xb = np.full(n, 0.5 * L)
        vb = np.zeros((n, 3))
        k = ev_ours["i"]
        for s in sorted(ev_ours["pending"]):
            xb[s] = X_raw[k]
            vb[s] = Z_v[k] * np.sqrt(1.38e-23 * ti_s / mass_s)
            k += 1
        return {"x": jnp.asarray(xb, jnp.float64),
                "vx": jnp.asarray(vb[:, 0], jnp.float64),
                "vy": jnp.asarray(vb[:, 1], jnp.float64),
                "vz": jnp.asarray(vb[:, 2], jnp.float64)}

    ev_ours = {"i": 0, "pending": []}
    monkeypatch.setattr(sources, "sample_source_6d", fake_sample_source)

    cfg = magnetized.MagnetizedConfig(
        grid=GridSpec(ng, L, "dirichlet-dirichlet"), dt=dt, te=te,
        b=tuple(B0), species_z=(1,), reactivate="source",
        react_timing="reference",
        source=magnetized.SourceSpec(mass=mass, charge_state=1.0, p2c=p2c,
                                     species_idx=0, ti=ti),
        source_sampler="threefry", react_batch=0,
        newton_tol=1e-9, newton_maxiter=1000,
    )
    st = magnetized.init_state(
        x0, v0, m=mass, charge_state=1.0, p2c=p2c, species_idx=0,
        cfg=cfg, dtype=jnp.float64,
    )
    step = magnetized.make_step(cfg)  # unjitted: the hook's rows change
    # per step

    total_react = 0
    for t in range(steps):
        grid_ref.weight_particles_to_grid_boltzmann(parts, dt)
        grid_ref.reset_added_particles()
        grid_ref.solve_for_phi_dirichlet_boltzmann()
        grid_ref.differentiate_phi_to_E_dirichlet()
        # slots the loop's else branch will reactivate THIS step (inactive
        # at loop start) — the engine's take set under 'reference' timing
        ev_ours["pending"] = [i for i, pt in enumerate(parts)
                              if not pt.is_active()]
        for pt in parts:
            if pt.is_active():
                pt.interpolate_electric_field_dirichlet(grid_ref)
                pt.push_6D(dt)
                pt.apply_BCs_dirichlet(grid_ref)
            else:
                # pic_bca_aps form (pygcpic.py:1545); pic_iead's
                # np.random.choice((True, True)) branch is constant-True
                pt.reactivate(source_distribution, grid_ref,
                              (t + 1) * dt, p2c, mass, 1, 1)
        st, mtr = step(st)

        n_react_ref = len(ev_ours["pending"])
        assert int(mtr.n_reactivated) == n_react_ref, t
        total_react += n_react_ref
        ev_ours["i"] += n_react_ref
        assert ev["i"] == ev_ours["i"], (t, ev["i"], ev_ours["i"])
        # ledger credit parity (consumed by the NEXT weight pass)
        np.testing.assert_allclose(float(st.added),
                                   grid_ref.added_particles, rtol=1e-12)
        phi_scale = max(np.max(np.abs(grid_ref.phi)), 1.0)
        np.testing.assert_allclose(
            np.asarray(mtr.phi, np.float64), grid_ref.phi,
            atol=2e-4 * phi_scale, rtol=0,
            err_msg=f"phi mismatch at step {t}")
        np.testing.assert_allclose(float(mtr.n0), grid_ref.n0, rtol=1e-8,
                                   err_msg=f"n0 mismatch at step {t}")
        # trajectories of every ACTIVE particle (including re-activated
        # rows once they re-enter)
        act = np.array([pt.is_active() for pt in parts])
        x_ref = np.array([pt.r[0] for pt in parts])
        v_ref = np.array([pt.r[3:6] for pt in parts])
        x_ours = np.asarray(st.p, np.float64)[:n] * dx
        assert np.array_equal(np.asarray(st.active)[:n] == 1, act), t
        np.testing.assert_allclose(x_ours[act], x_ref[act],
                                   atol=1e-7 * L, rtol=0,
                                   err_msg=f"x mismatch at step {t}")
        v_ours = np.stack(
            [np.asarray(st.vx, np.float64), np.asarray(st.vy, np.float64),
             np.asarray(st.vz, np.float64)], axis=-1)[:n]
        np.testing.assert_allclose(v_ours[act], v_ref[act],
                                   atol=1e-4 * vth, rtol=0,
                                   err_msg=f"v mismatch at step {t}")
    assert total_react >= len(planted), "re-activation never fired"


def test_magnetized_capped_source_matches_reference_reactivate_or_delete(
        ref, monkeypatch):
    """pic_bca_aps's reactivate-or-delete cap (pygcpic.py:1543-1549): the
    else branch reactivates an inactive slot only while the active ionized
    source-species count is below source_N — and that count is
    re-evaluated per particle DURING the loop, so exactly the first
    (source_N - count) inactive slots in index order re-enter; the rest
    stay free (the reference queues them for deletion; the fixed-capacity
    rebuild leaves them as free slots — active populations identical).
    Driven through the ACTUAL Particle.reactivate + generator with the
    replayed stream; our side uses reactivate='capped-source' whose
    rank-capped take set must select the same slots and consume the same
    draws in the same order."""
    _, ref_gc = ref
    from pypic_tpu import sources
    from pypic_tpu.engines import magnetized
    from pypic_tpu.grid import GridSpec

    rng = np.random.default_rng(59)
    ng, n, steps = 64, 160, 8
    te = ti = 10.0 * 11600.0
    density = 1e16
    debye = np.sqrt(1.38e-23 * te * 8.854e-12 / 1.602e-19**2 / density)
    L = 100.0 * debye
    dt = 1e-10
    p2c = density * L / n
    mass = 2.0 * 1.67e-27
    alpha = 86.0 * np.pi / 180.0
    B0 = np.array([2.0 * np.cos(alpha), 2.0 * np.sin(alpha), 0.0])
    dx = L / (ng - 1)

    x0 = rng.uniform(0.4 * L, 0.6 * L, n)
    vth = np.sqrt(1.38e-23 * ti / mass)
    v0 = rng.normal(0.0, vth, (n, 3))
    # wave A: 6 wall-bound ions lost in step 1 (pending from step 2)
    planted = np.array([5, 31, 66, 99, 120, 151])
    x0[planted] = 0.2 * dx
    v0[planted, 0] = -1e6
    # wave B: 3 more ions timed to hit DURING step 2 (0.4 dx inbound at
    # 0.27 dx/step), at slots interleaved with wave A — the reference's
    # during-loop count sees a wave-B particle at a HIGHER index as still
    # active when a lower pending slot is considered, so with the cap
    # binding the admitted SET is not a rank prefix: the reference admits
    # {5, 31, 99, 151} and leaves {66, 120} free (a naive post-push
    # deficit prefix would admit {5, 31, 66, 99})
    wave_b = np.array([2, 70, 140])
    x0[wave_b] = 0.4 * dx
    v0[wave_b, 0] = -1e6
    source_n = n - 5

    max_events = 64
    X_raw = rng.normal(L / 2.0, L / 12.0, max_events) % L
    Z_v = rng.normal(0.0, 1.0, (max_events, 3))

    grid_ref = ref_gc.Grid(ng, L, te, bc="dirichlet-dirichlet")
    parts = []
    for i in range(n):
        pt = ref_gc.Particle(mass, 1, p2c, ti, Z=1, B0=B0.copy(),
                             E0=np.zeros(3), grid=grid_ref)
        pt.r[:] = 0.0
        pt.r[0] = x0[i]
        pt.r[3:6] = v0[i]
        parts.append(pt)
    source_distribution = ref_gc.source_distribution_6D(grid_ref, ti, mass)

    ev = {"i": 0}

    def fake_np_normal(loc=0.0, scale=1.0, size=None):
        if size == 3:
            return Z_v[ev["i"] - 1] * scale
        assert size is None and loc == grid_ref.length / 2.0
        x = X_raw[ev["i"]]
        ev["i"] += 1
        return x

    monkeypatch.setattr(np.random, "normal", fake_np_normal)

    # the slots the reference ADMITTED this step, in admission (= slot)
    # order: under a binding cap with same-step losses the admitted set
    # is NOT a rank prefix of the pending slots, and the generator's
    # draws are consumed only by admitted slots — the engine-side table
    # must mirror that consumption exactly
    ev_ours = {"i": 0, "admitted": []}

    def fake_sample_source(key, n_draw, grid_s, ti_s, mass_s, vx=0.0,
                           components=True):
        assert n_draw == n
        xb = np.full(n, 0.5 * L)
        vb = np.zeros((n, 3))
        k = ev_ours["i"]
        for s in ev_ours["admitted"]:
            xb[s] = X_raw[k]
            vb[s] = Z_v[k] * np.sqrt(1.38e-23 * ti_s / mass_s)
            k += 1
        return {"x": jnp.asarray(xb, jnp.float64),
                "vx": jnp.asarray(vb[:, 0], jnp.float64),
                "vy": jnp.asarray(vb[:, 1], jnp.float64),
                "vz": jnp.asarray(vb[:, 2], jnp.float64)}

    monkeypatch.setattr(sources, "sample_source_6d", fake_sample_source)

    cfg = magnetized.MagnetizedConfig(
        grid=GridSpec(ng, L, "dirichlet-dirichlet"), dt=dt, te=te,
        b=tuple(B0), species_z=(1,), reactivate="capped-source",
        react_timing="reference", source_n=source_n,
        source=magnetized.SourceSpec(mass=mass, charge_state=1.0, p2c=p2c,
                                     species_idx=0, ti=ti),
        source_sampler="threefry", react_batch=0,
        newton_tol=1e-9, newton_maxiter=1000,
    )
    st = magnetized.init_state(
        x0, v0, m=mass, charge_state=1.0, p2c=p2c, species_idx=0,
        cfg=cfg, dtype=jnp.float64,
    )
    step = magnetized.make_step(cfg)

    total_react = total_deferred = 0
    for t in range(steps):
        grid_ref.weight_particles_to_grid_boltzmann(parts, dt)
        grid_ref.reset_added_particles()
        grid_ref.solve_for_phi_dirichlet_boltzmann()
        grid_ref.differentiate_phi_to_E_dirichlet()
        n_pending = sum(1 for pt in parts if not pt.is_active())
        ev_ours["admitted"] = []
        for slot, pt in enumerate(parts):
            if pt.is_active():
                pt.interpolate_electric_field_dirichlet(grid_ref)
                pt.push_6D(dt)
                pt.apply_BCs_dirichlet(grid_ref)
            else:
                # pygcpic.py:1543-1549, count re-evaluated per particle
                count = sum(1 for p in parts
                            if (p.Z == 1 and p.is_active()
                                and p.charge_state > 0))
                if count < source_n:
                    pt.reactivate(source_distribution, grid_ref,
                                  (t + 1) * dt, p2c, mass, 1, 1)
                    pt.from_wall = 0
                    pt.at_wall = 0
                    ev_ours["admitted"].append(slot)
                # else: deletion-flagged in the reference; a free slot here

        st, mtr = step(st)
        n_react_ref = len(ev_ours["admitted"])
        assert int(mtr.n_reactivated) == n_react_ref, t
        if t == 1:
            # the designed non-prefix admission: wave B's during-loop
            # countability rejects mid-sequence pending slots
            assert ev_ours["admitted"] == [5, 31, 99, 151], \
                ev_ours["admitted"]
        total_react += n_react_ref
        total_deferred += n_pending - n_react_ref
        ev_ours["i"] += n_react_ref
        assert ev["i"] == ev_ours["i"], (t, ev["i"], ev_ours["i"])
        np.testing.assert_allclose(float(st.added),
                                   grid_ref.added_particles, rtol=1e-12)
        np.testing.assert_allclose(float(mtr.n0), grid_ref.n0, rtol=1e-8,
                                   err_msg=f"n0 mismatch at step {t}")
        act = np.array([pt.is_active() for pt in parts])
        assert np.array_equal(np.asarray(st.active)[:n] == 1, act), t
        x_ref = np.array([pt.r[0] for pt in parts])
        np.testing.assert_allclose(
            np.asarray(st.p, np.float64)[:n][act] * dx, x_ref[act],
            atol=1e-7 * L, rtol=0, err_msg=f"x mismatch at step {t}")
    assert total_react >= 2, "cap never admitted anyone"
    assert total_deferred >= 2, "cap never bound — dead A/B"


def test_dn_flux_inflow_cycle_matches_reference(ref, monkeypatch):
    """Multi-step dirichlet_neumann_test cycle WITH the flux inflow
    (pygcpic.py:2020-2060): D-N Newton-Boltzmann solve, pushes, wall
    losses, and the per-step flux-capped re-injection through the ACTUAL
    Particle.reactivate + flux_distribution_6D (pygcpic.py:760-778) with
    every np.random call replayed from recorded tables — the position
    uniform, the 3-velocity normal, the CDF-table np.random.choice, the
    half-bin jitter uniform, and the gamma perturbed-beam decision —
    plus the driver's own r[3] = -abs(r[3]) quirk (pygcpic.py:2059).
    The round-4 harness could compare only ONE cold D-N cycle because the
    unforced half-sheath is unstable; the inflow is what stabilizes the
    real driver, and the replayed stream makes it comparable."""
    _, ref_gc = ref
    from pypic_tpu import sources
    from pypic_tpu.engines import magnetized
    from pypic_tpu.grid import GridSpec

    rng = np.random.default_rng(83)
    # the driver's NUMERICAL regime, scaled down: ~64 particles/node
    # (50000/800) AND dx ~ 0.5 Debye lengths (400 LD / 800 nodes) — a
    # coarser dx under-resolves the wall sheath and sends the reference's
    # D-N Newton into exp overflow within two steps (measured)
    ng, n, steps = 64, 4096, 25
    te = ti = 10.0 * 11600.0
    density = 1e19
    debye = np.sqrt(1.38e-23 * te * 8.854e-12 / 1.602e-19**2 / density)
    L = 32.0 * debye
    dt = 2e-10
    p2c = density * L / n
    mass = 1.67e-27
    B0 = np.zeros(3)
    dx = L / (ng - 1)
    flux_cap = 16
    flux_gamma, vx_pert = 0.5, -3.0
    vx_drift = 0.0
    vth = np.sqrt(1.38e-23 * ti / mass)

    # the driver's initial population: full domain, inbound vx
    x0 = rng.uniform(0.02 * L, 0.98 * L, n)
    v0 = rng.normal(0.0, vth, (n, 3))
    v0[:, 0] = -np.abs(v0[:, 0])  # pygcpic.py:1999

    # --- recorded stream, one row per re-injection EVENT ---
    # the generator's CDF table (pygcpic.py:765-771), identical every event
    num_vels = 100
    vels = np.linspace(-6 * vth, 6 * vth, num_vels)
    dist = np.array([ref_gc.weighted_gaussian(v, vx_drift, vth)
                     for v in vels])
    dist /= dist.sum()
    max_events = steps * flux_cap
    U_x = rng.uniform(0.0, 1.0, max_events)
    Z3 = rng.normal(0.0, 1.0, (max_events, 3))
    CH = vels[rng.choice(num_vels, size=max_events, p=dist)]
    JIT = rng.uniform(-1.0, 1.0, max_events)
    UG = rng.uniform(0.0, 1.0, max_events)
    dv_half = (vels[1] - vels[0]) / 2.0

    def gen_vx(e):
        """r[3] as flux_distribution_6D yields it (pre-driver-quirk)."""
        if UG[e] < flux_gamma:
            return vx_pert * vth
        return -abs(CH[e]) + JIT[e] * dv_half + vx_drift

    # --- reference side: actual generator with np.random replayed ---
    grid_ref = ref_gc.Grid(ng, L, te, bc="dirichlet-neumann")
    parts = []
    for i in range(n):
        pt = ref_gc.Particle(mass, 1, p2c, ti, Z=1, B0=B0.copy(),
                             E0=np.zeros(3), grid=grid_ref)
        pt.r[:] = 0.0
        pt.r[0] = x0[i]
        pt.r[3:6] = v0[i]
        parts.append(pt)
    flux_distribution = ref_gc.flux_distribution_6D(
        grid_ref, ti, mass, vx=vx_drift, gamma=flux_gamma, vx_pert=vx_pert)

    ev = {"i": 0, "phase": 0}

    def fake_uniform(lo=0.0, hi=1.0, size=None):
        assert size is None
        if (lo, hi) == (-1, 1):
            return JIT[ev["i"]]
        assert float(lo) == 0.0 and float(hi) == 1.0
        if ev["phase"] == 0:  # position draw opens the event
            ev["phase"] = 1
            return U_x[ev["i"]]
        ev["phase"] = 0  # gamma decision closes it
        u = UG[ev["i"]]
        ev["i"] += 1
        return u

    def fake_normal(loc=0.0, scale=1.0, size=None):
        assert size == 3 and loc == 0.0
        return Z3[ev["i"]] * scale

    def fake_choice(a, size=None, p=None):
        return CH[ev["i"]]

    monkeypatch.setattr(np.random, "uniform", fake_uniform)
    monkeypatch.setattr(np.random, "normal", fake_normal)
    monkeypatch.setattr(np.random, "choice", fake_choice)

    # --- our side: the same stream through the flux sampler hook ---
    ev_ours = {"i": 0, "admitted": []}

    def fake_sample_flux(key, n_draw, grid_s, ti_s, mass_s, vx=0.0,
                        gamma=0.0, vx_pert=0.0, components=True):
        assert n_draw == n
        xb = np.full(n, 0.5 * L)
        vb = np.zeros((n, 3))
        k = ev_ours["i"]
        for s in ev_ours["admitted"]:
            xb[s] = L - dx * U_x[k]
            vb[s] = (gen_vx(k), Z3[k, 1] * vth, Z3[k, 2] * vth)
            k += 1
        return {"x": jnp.asarray(xb, jnp.float64),
                "vx": jnp.asarray(vb[:, 0], jnp.float64),
                "vy": jnp.asarray(vb[:, 1], jnp.float64),
                "vz": jnp.asarray(vb[:, 2], jnp.float64)}

    monkeypatch.setattr(sources, "sample_flux_6d", fake_sample_flux)

    cfg = magnetized.MagnetizedConfig(
        grid=GridSpec(ng, L, "dirichlet-neumann"), dt=dt, te=te,
        b=tuple(B0), species_z=(1,), reactivate="flux",
        react_timing="reference", flux_limit=flux_cap,
        flux_gamma=flux_gamma, flux_vx_pert=vx_pert,
        source=magnetized.SourceSpec(mass=mass, charge_state=1.0, p2c=p2c,
                                     species_idx=0, ti=ti, vx=vx_drift),
        source_sampler="threefry", react_batch=0,
    )
    st = magnetized.init_state(
        x0, v0, m=mass, charge_state=1.0, p2c=p2c, species_idx=0,
        cfg=cfg, dtype=jnp.float64,
    )
    step = magnetized.make_step(cfg)

    total_react = 0
    for t in range(steps):
        grid_ref.weight_particles_to_grid_boltzmann(parts, dt)
        grid_ref.reset_added_particles()
        grid_ref.solve_for_phi_dirichlet_neumann_boltzmann()
        grid_ref.differentiate_phi_to_E_dirichlet()
        ev_ours["admitted"] = [i for i, pt in enumerate(parts)
                               if not pt.is_active()][:flux_cap]
        flux_counter = 0
        for pt in parts:
            if pt.is_active():
                pt.interpolate_electric_field_dirichlet(grid_ref)
                pt.push_6D(dt)
                pt.apply_BCs_dirichlet(grid_ref)
            elif flux_counter < flux_cap:
                # pygcpic.py:2056-2059 incl. the driver-side -abs quirk
                pt.reactivate(flux_distribution, grid_ref,
                              (t + 1) * dt, p2c, mass, 1, 1)
                pt.r[3] = -np.abs(pt.r[3])
                flux_counter += 1

        st, mtr = step(st)
        assert int(mtr.n_reactivated) == flux_counter, t
        total_react += flux_counter
        ev_ours["i"] += flux_counter
        assert ev["i"] == ev_ours["i"], (t, ev["i"], ev_ours["i"])
        np.testing.assert_allclose(float(st.added),
                                   grid_ref.added_particles, rtol=1e-12)
        np.testing.assert_allclose(float(mtr.n0), grid_ref.n0, rtol=1e-5,
                                   err_msg=f"n0 mismatch at step {t}")
        act = np.array([pt.is_active() for pt in parts])
        assert np.array_equal(np.asarray(st.active)[:n] == 1, act), t
        phi_scale = max(np.max(np.abs(grid_ref.phi)), 1.0)
        # this variant's Newton stops at |dphi| < 1e-3 and the reference
        # solves its Jacobian densely vs our Sherman-Morrison tridiag; the
        # per-solve O(1e-3 V) differences random-walk through the rho and
        # wall feedback over the horizon
        np.testing.assert_allclose(
            np.asarray(mtr.phi, np.float64), grid_ref.phi,
            atol=5e-2 * phi_scale, rtol=0,
            err_msg=f"phi mismatch at step {t}")
        x_ref = np.array([pt.r[0] for pt in parts])
        np.testing.assert_allclose(
            np.asarray(st.p, np.float64)[:n][act] * dx, x_ref[act],
            atol=1e-4 * L, rtol=0, err_msg=f"x mismatch at step {t}")
    assert total_react >= flux_cap, "inflow never fired"


# ---------------------------------------------------------------------------
# forced MCC ionization + ledger -> n0 recurrence (pygcpic.py:387-398)
# ---------------------------------------------------------------------------


def test_forced_ionization_and_ledger_match_reference(ref):
    """One FORCED first-ionization sweep (pygcpic.py:387-398 through the
    actual Particle.attempt_first_ionization with the probability pinned
    >= 1 by construction — the uniform decision is then deterministic on
    both sides and the recorded stream is unnecessary) + the
    grid.add_particles credit (pygcpic.py:1115-1117) consumed by the
    adaptive-n0 recurrence at the NEXT weighting (pygcpic.py:900-902).
    Workload notes: the probability n_loc^2 R dx dt / p2c is pinned >= 1
    NOT by inflating dt (any dt big enough breaks the n0 recurrence's
    fn = sqrt(ve q dt / p) factor and sends both solvers into garbage)
    but by giving the NEUTRAL rows a tiny per-particle p2c — probability
    is per-particle and scales 1/p2c, while the tiny rows' deposits and
    ledger credits stay consistently negligible on both sides. The ion
    background keeps the workload at the deterministic D-D cycle test's
    scales (same band, same dt)."""
    _, ref_gc = ref
    from pypic_tpu.engines import magnetized
    from pypic_tpu.grid import GridSpec

    rng = np.random.default_rng(67)
    ng, n, steps = 64, 192, 3
    te = ti = 10.0 * 11600.0
    density = 1e16
    debye = np.sqrt(1.38e-23 * te * 8.854e-12 / 1.602e-19**2 / density)
    L = 100.0 * debye
    dx = L / (ng - 1)
    dt = 1e-10
    mass = 2.0 * 1.67e-27
    alpha = 86.0 * np.pi / 180.0
    B0 = np.array([2.0 * np.cos(alpha), 2.0 * np.sin(alpha), 0.0])

    # half ions carrying the full density, half tiny-p2c neutrals
    half = n // 2
    cs0 = np.concatenate([np.ones(half), np.zeros(n - half)])
    p2c_ion = density * L / half
    # pin: prob = n_loc^2 R dx dt / p2c_n >= 1 with 10x margin at the
    # band's MINIMUM plausible local density (~the average)
    rate_ref = np.interp(te, [T * 11600.0 for T in [8.626e-01, 1.011e00,
                         2.178e00, 3.539e00, 5.146e00, 7.069e00, 9.410e00,
                         1.231e01, 1.598e01, 2.076e01, 2.720e01, 3.625e01,
                         4.973e01, 7.133e01, 1.099e02, 1.904e02, 4.079e02,
                         1.355e03, 1.390e04, 8.595e04]],
                         [R / 1e6 for R in [7.553e-16, 8.291e-15, 1.714e-11,
                          2.470e-10, 9.985e-10, 2.398e-09, 4.412e-09,
                          6.940e-09, 9.869e-09, 1.309e-08, 1.649e-08,
                          1.996e-08, 2.329e-08, 2.624e-08, 2.834e-08,
                          2.881e-08, 2.627e-08, 1.926e-08, 8.109e-09,
                          3.829e-09]])
    p2c_n = 0.1 * density**2 * rate_ref * dx * dt
    assert p2c_n > 0
    p2c_all = np.where(cs0 == 1, p2c_ion, p2c_n)
    x0 = rng.uniform(0.4 * L, 0.6 * L, n)
    vth = np.sqrt(1.38e-23 * ti / mass)
    v0 = rng.normal(0.0, vth, (n, 3))

    grid_ref = ref_gc.Grid(ng, L, te, bc="dirichlet-dirichlet")
    parts = []
    for i in range(n):
        pt = ref_gc.Particle(mass, int(cs0[i]), p2c_all[i], ti, Z=1,
                             B0=B0.copy(), E0=np.zeros(3), grid=grid_ref)
        pt.r[:] = 0.0
        pt.r[0] = x0[i]
        pt.r[3:6] = v0[i]
        pt.charge_state = int(cs0[i])
        parts.append(pt)

    cfg = magnetized.MagnetizedConfig(
        grid=GridSpec(ng, L, "dirichlet-dirichlet"), dt=dt, te=te,
        b=tuple(B0), species_z=(1,), reactivate="none",
        ionization=True, max_charge_state=1,
        newton_tol=1e-9, newton_maxiter=1000,
    )
    st = magnetized.init_state(
        x0, v0, m=mass, charge_state=cs0.astype(np.float64), p2c=p2c_all,
        species_idx=0, cfg=cfg, dtype=jnp.float64,
    )
    step = jax.jit(magnetized.make_step(cfg))
    n_neutral = int(np.sum(cs0 == 0))

    for t in range(steps):
        grid_ref.weight_particles_to_grid_boltzmann(parts, dt)
        grid_ref.reset_added_particles()
        grid_ref.solve_for_phi_dirichlet_boltzmann()
        grid_ref.differentiate_phi_to_E_dirichlet()
        for pt in parts:
            pt.interpolate_electric_field_dirichlet(grid_ref)
            pt.push_6D(dt)
            pt.apply_BCs_dirichlet(grid_ref)
            if (pt.Z == 1 and pt.charge_state == 0 and pt.is_active()):
                # pic_bca_aps gate (pygcpic.py:1510-1511); probability
                # pinned >= 1 makes the np.random.uniform decision
                # deterministic
                pt.attempt_first_ionization(dt, te, grid_ref)
        st, mtr = step(st)

        cs_ref = np.array([pt.charge_state for pt in parts], np.float64)
        cs_ours = np.asarray(st.charge_state, np.float64)[:n]
        if t == 0:
            # the forced sweep: EVERY neutral ionized on both sides
            assert int(mtr.n_ionized) == n_neutral
            assert np.all(cs_ref == 1.0), "probability pin failed (ref)"
        else:
            assert int(mtr.n_ionized) == 0  # cs=1 == max_charge_state
        np.testing.assert_array_equal(cs_ours, cs_ref)
        # ledger credit: sum(2 p2c) over ionized (pygcpic.py:398, 1116)
        np.testing.assert_allclose(float(st.added),
                                   grid_ref.added_particles, rtol=1e-12)
        # the credit's consumption by the adaptive-n0 recurrence
        np.testing.assert_allclose(float(mtr.n0), grid_ref.n0, rtol=1e-9,
                                   err_msg=f"n0 mismatch at step {t}")
        phi_scale = max(np.max(np.abs(grid_ref.phi)), 1.0)
        np.testing.assert_allclose(
            np.asarray(mtr.phi, np.float64), grid_ref.phi,
            atol=1e-4 * phi_scale, rtol=0,
            err_msg=f"phi mismatch at step {t}")
        # confined band over a 3-step window: nobody walls out
        assert all(pt.is_active() for pt in parts)
        assert int(np.sum(np.asarray(st.active)[:n] == 1)) == n
        x_ref = np.array([pt.r[0] for pt in parts])
        np.testing.assert_allclose(
            np.asarray(st.p, np.float64)[:n] * dx, x_ref,
            atol=1e-7 * L, rtol=0, err_msg=f"x mismatch at step {t}")


# ---------------------------------------------------------------------------
# long-horizon D-D pic_iead (adaptive-n0 feedback; VERDICT round-4 item 5)
# ---------------------------------------------------------------------------


def test_magnetized_dd_cycle_long_horizon(ref):
    """120 matched pic_iead D-D cycles (24x the deterministic harness's
    window): the adaptive-n0 recurrence (pygcpic.py:889-904) is a feedback
    loop — this asserts it TRACKS through its own feedback, not just over
    5 steps. Confined thermal population (no wall hits, reactivate off,
    no RNG on either side). The reference's inner bicgstab (default rtol)
    leaves O(1e-4)-relative self-error per Newton solve that random-walks
    through the rho feedback; the n0 recurrence itself is insensitive to
    that noise (the eta quirk divides phi by Te*11600), so n0 is asserted
    tight while phi/x get the measured random-walk envelope with margin."""
    _, ref_gc = ref
    from pypic_tpu.engines import magnetized
    from pypic_tpu.grid import GridSpec

    rng = np.random.default_rng(71)
    ng, n, steps = 64, 256, 120
    te = ti = 10.0 * 11600.0
    density = 1e16
    debye = np.sqrt(1.38e-23 * te * 8.854e-12 / 1.602e-19**2 / density)
    L = 100.0 * debye
    dt = 1e-10
    p2c = density * L / n
    mass = 2.0 * 1.67e-27
    alpha = 86.0 * np.pi / 180.0
    B0 = np.array([2.0 * np.cos(alpha), 2.0 * np.sin(alpha), 0.0])
    dx = L / (ng - 1)

    x0 = rng.uniform(0.4 * L, 0.6 * L, n)
    vth = np.sqrt(1.38e-23 * ti / mass)
    v0 = rng.normal(0.0, vth, (n, 3))

    grid_ref = ref_gc.Grid(ng, L, te, bc="dirichlet-dirichlet")
    parts = []
    for i in range(n):
        pt = ref_gc.Particle(mass, 1, p2c, ti, Z=1, B0=B0.copy(),
                             E0=np.zeros(3), grid=grid_ref)
        pt.r[:] = 0.0
        pt.r[0] = x0[i]
        pt.r[3:6] = v0[i]
        parts.append(pt)

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
            assert pt.is_active(), f"wall hit at step {t} — bad workload"
            pt.interpolate_electric_field_dirichlet(grid_ref)
            pt.push_6D(dt)
            pt.apply_BCs_dirichlet(grid_ref)
        st, mtr = step(st)
        assert int(mtr.n_hit_wall) == 0
        np.testing.assert_allclose(float(mtr.n0), grid_ref.n0, rtol=1e-6,
                                   err_msg=f"n0 mismatch at step {t}")

    phi_scale = max(np.max(np.abs(grid_ref.phi)), 1.0)
    np.testing.assert_allclose(
        np.asarray(mtr.phi, np.float64), grid_ref.phi,
        atol=5e-2 * phi_scale, rtol=0)
    x_ref = np.array([pt.r[0] for pt in parts])
    x_ours = np.asarray(st.p, np.float64)[:n] * dx
    np.testing.assert_allclose(x_ours, x_ref, atol=1e-4 * L, rtol=0)
