"""Physics and lifecycle tests for the bounded sheath engine (PIC_L_DD)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pypic_tpu.constants import (
    E_CHARGE,
    EPSILON_0,
    K_BOLTZMANN,
    M_ELECTRON,
    M_PROTON,
)
from pypic_tpu.grid import GridSpec
from pypic_tpu import initialize as init
from pypic_tpu.engines import sheath
from pypic_tpu.runner import run


def _setup(n=10_000, ng=51, gamma=0.0, seed=3):
    # Reference config (PIC_L_DD.py:320-331) at reduced N.
    density = 1e19
    dt = 1e-12
    dx = 1e-5
    te = 10.0 * 11600.0
    ti = 10.0 * 11600.0
    length = dx * (ng - 1)
    grid = GridSpec(ng, length, "dirichlet-dirichlet")
    d = init.initialize_sheath(n, density, 1.0, 0.0, grid, te, ti, seed=seed)
    p2c = length * density / n
    cfg = sheath.SheathConfig(
        grid, dt, p2c,
        kbte=K_BOLTZMANN * te, kbti=K_BOLTZMANN * ti,
        gamma=gamma, exit_hist_vmax=3e6, record_exit_after_step=300,
    )
    st = sheath.init_state(d["x"], d["v"], d["q"], d["m"], d["species"], cfg, seed=1)
    return cfg, st, te


def test_sheath_formation_wall_potential():
    """Absorbing walls charge negative: after electron-scale transients the
    wall potential sits several Te/e below the quasi-neutral core, of the
    order of the floating potential (PIC_L_DD.py:349 prints 28 V for these
    parameters; re-injected plasma at ~ion-transit time reaches roughly
    half)."""
    cfg, st, te = _setup()
    _, m = run(sheath.make_step(cfg), st, 1500)
    phi = np.asarray(m.phi, np.float64)[-300:].mean(axis=0)
    te_volts = te * K_BOLTZMANN / E_CHARGE  # 10 V
    drop_l = phi[0] - phi.max()
    drop_r = phi[-1] - phi.max()
    assert drop_l < -0.5 * te_volts, f"left wall drop {drop_l}"
    assert drop_r < -0.5 * te_volts, f"right wall drop {drop_r}"
    assert drop_l > -4.0 * te_volts and drop_r > -4.0 * te_volts
    # core is the potential maximum (quasi-neutral plasma)
    assert np.argmax(phi) not in (0, len(phi) - 1)


def test_sheath_picard_telemetry_and_counts():
    cfg, st, _ = _setup(n=4000)
    _, m = run(sheath.make_step(cfg), st, 200)
    iters = np.asarray(m.picard_iters)
    assert iters.max() <= cfg.maxiter
    n_act = np.asarray(m.n_active)
    assert (n_act <= 4000).all() and (n_act > 3000).all()
    # particles absorbed during a step are re-injected at the next step start
    lost = np.asarray(m.n_lost_left) + np.asarray(m.n_lost_right)
    assert (n_act + lost == 4000).all()


def test_exit_velocity_histograms_accumulate():
    cfg, st, _ = _setup(n=4000)
    fin, _ = run(sheath.make_step(cfg), st, 600)
    hist = np.asarray(fin.exit_hist)
    assert hist.shape == (2, cfg.exit_hist_bins)
    assert hist.sum() > 0  # both species hit walls in a 10 eV sheath run
    assert (hist >= 0).all()


def test_thermostat_resamples_to_ion_temperature():
    """gamma=1 resamples every active particle's velocities each step to the
    ion temperature (PIC_L_DD.py:420-427)."""
    cfg, st, _ = _setup(n=20_000, gamma=1.0)
    # make electrons hot so the resample is visible
    st = st.replace(u=st.u * 5.0, vy=st.vy * 5.0, vz=st.vz * 5.0)
    fin, _ = run(sheath.make_step(cfg), st, 1)
    v = np.asarray(fin.v)
    m = np.asarray(fin.m)
    act = np.asarray(fin.active) == 1
    for sp, mass in ((1, M_ELECTRON), (2, M_PROTON)):
        sel = act & (np.asarray(fin.species) == sp)
        vth = np.sqrt(K_BOLTZMANN * 10.0 * 11600.0 / mass)
        # transverse components are untouched by the push -> exact thermostat
        std = v[sel, 1].std()
        assert 0.9 * vth < std < 1.1 * vth, (sp, std, vth)


def test_rng_samplers_match_threefry_distribution():
    """'hash' (counter-based) draws re-injection/thermostat randomness from
    the same distribution as 'threefry': after the same run length both
    produce the same sheath potential profile and loss statistics within
    Monte-Carlo tolerance."""
    import dataclasses as dc

    outs = {}
    for sampler in ("hash", "threefry"):
        cfg, st, te = _setup(n=20_000)
        cfg = dc.replace(cfg, rng_sampler=sampler)
        fin, m = run(sheath.make_step(cfg), st, 800)
        outs[sampler] = (fin, m)
    te_volts = te * K_BOLTZMANN / E_CHARGE
    phis = {
        k: np.asarray(m.phi, np.float64)[-200:].mean(axis=0)
        for k, (_, m) in outs.items()
    }
    losses = {
        k: (np.asarray(m.n_lost_left) + np.asarray(m.n_lost_right))[
            -200:].mean()
        for k, (_, m) in outs.items()
    }
    for sampler in ("hash",):
        # same time-averaged sheath profile (stochastic-noise tolerance)
        np.testing.assert_allclose(phis[sampler], phis["threefry"],
                                   atol=0.35 * te_volts)
        assert abs(losses[sampler] - losses["threefry"]) < 0.15 * max(
            1.0, losses["threefry"]
        ), losses
    with pytest.raises(ValueError, match="rng_sampler"):
        dc.replace(cfg, rng_sampler="nope")


def test_wall_charge_current_terms():
    """An absorbed particle deposits the reference's wall surface-charge
    current: j[0] += dx q p2c / dt for left-absorbed (PIC_L_DD.py:55-63),
    exercised by forcing a particle through the wall in one step."""
    ng = 11
    dx = 1e-5
    grid = GridSpec(ng, dx * (ng - 1), "dirichlet-dirichlet")
    dt = 1e-12
    p2c = 1e10
    cfg = sheath.SheathConfig(
        grid, dt, p2c, kbte=1e-19, kbti=1e-19, tol=1e30, maxiter=1
    )
    # one ion flying left through the wall fast enough to cross in one dt
    x = np.asarray([0.5 * dx])
    v3 = np.asarray([[-1e7, 0.0, 0.0]])
    q = np.asarray([E_CHARGE])
    m = np.asarray([M_PROTON])
    species = np.asarray([2])
    st = sheath.init_state(x, v3, q, m, species, cfg, seed=0)
    fin, met = run(sheath.make_step(cfg), st, 1)
    assert int(np.asarray(met.n_lost_left)[0]) == 1
    j = np.asarray(fin.j)
    expected = dx * E_CHARGE * p2c / dt  # wall term, folded with j[1]
    assert j[0] != 0.0
    np.testing.assert_allclose(j[0], expected, rtol=1e-5)


def test_sheath_floor_exit_and_anderson_fewer_iters_same_sheath():
    """The f32 residual-floor exit (tol_floor, round 3): the reference's
    absolute tolerance is unattainable in f32 once the field reaches sheath
    magnitude, so without the floor the Picard loop grinds round-off to
    maxiter; with it (default) the loop exits in a handful of iterations at
    the same sheath potential. Anderson mixing + extrapolated init stays
    no worse than the plain loop under the floor exit."""
    import dataclasses

    cfg, st, te = _setup(n=8_000)
    cfg_grind = dataclasses.replace(cfg, tol_floor=0.0)
    cfg_a = dataclasses.replace(cfg, picard_init="extrapolate",
                                picard_accel="anderson")
    _, m_g = run(sheath.make_step(cfg_grind), st, 400)
    _, m_b = run(sheath.make_step(cfg), st, 400)
    _, m_a = run(sheath.make_step(cfg_a), st, 400)
    it_g = np.asarray(m_g.picard_iters, np.float64)[-200:].mean()
    it_b = np.asarray(m_b.picard_iters, np.float64)[-200:].mean()
    it_a = np.asarray(m_a.picard_iters, np.float64)[-200:].mean()
    assert it_b < it_g - 2.0, (it_b, it_g)  # floor exit saves iterations
    assert it_a <= it_b + 0.5, (it_a, it_b)  # mixing never hurts
    phi_g = np.asarray(m_g.phi, np.float64)[-100:].mean(axis=0)
    phi_b = np.asarray(m_b.phi, np.float64)[-100:].mean(axis=0)
    phi_a = np.asarray(m_a.phi, np.float64)[-100:].mean(axis=0)
    scale = np.abs(phi_g).max()
    # same sheath with and without the floor exit / mixing
    np.testing.assert_allclose(phi_b, phi_g, atol=0.05 * scale)
    np.testing.assert_allclose(phi_a, phi_g, atol=0.05 * scale)


def test_sheath_data_parallel_matches_single_device():
    """Data-parallel sheath: per-shard current deposits incl. the wall
    surface-charge terms psum before the edge fold, exit histograms and
    counters psum, and the hash sampler's slot-offset counters make
    thermostat + re-injection draws shard-count-INVARIANT — the 8-shard
    run reproduces the single-device hash run's dynamics."""
    import dataclasses as dc

    from pypic_tpu.parallel import make_mesh, make_data_parallel_step
    from pypic_tpu.parallel.dataparallel import shard_state

    cfg, st, te = _setup(n=8192, gamma=0.05)
    steps = 60
    cfg1 = dc.replace(cfg, rng_sampler="hash")
    _, m1 = run(sheath.make_step(cfg1), st, steps)

    mesh = make_mesh(8)
    cfg8 = dc.replace(cfg1, axis_name="particles")
    step8 = make_data_parallel_step(
        sheath.make_step, cfg8, mesh, example_state=st)
    _, m8 = run(step8, shard_state(st, mesh), steps)

    # identical RNG draws -> identical absorption/re-injection counts;
    # field trajectories agree to f32 psum-reordering tolerance
    np.testing.assert_array_equal(np.asarray(m8.n_active),
                                  np.asarray(m1.n_active))
    np.testing.assert_array_equal(
        np.asarray(m8.n_lost_left) + np.asarray(m8.n_lost_right),
        np.asarray(m1.n_lost_left) + np.asarray(m1.n_lost_right))
    f1 = np.asarray(m1.field_energy, np.float64)
    f8 = np.asarray(m8.field_energy, np.float64)
    np.testing.assert_allclose(f8, f1, rtol=1e-3)
    k1 = np.asarray(m1.kinetic_energy, np.float64)
    k8 = np.asarray(m8.kinetic_energy, np.float64)
    np.testing.assert_allclose(k8, k1, rtol=1e-4)


def test_sheath_dp_config_validation():
    import dataclasses as dc

    cfg, st, te = _setup(n=64)
    with pytest.raises(ValueError, match="shard-invariant"):
        dc.replace(cfg, axis_name="particles", rng_sampler="threefry")
    with pytest.raises(ValueError, match="rng_sampler"):
        dc.replace(cfg, axis_name="particles", rng_sampler="pallas")


def test_sheath_tol_floor_uses_working_dtype():
    """Under x64 the reference's ABSOLUTE Picard tolerance is attainable:
    the round-off floor must use eps of the working dtype, not hard-coded
    f32 eps (which forced an early exit at f32-level residuals ~3 orders
    above tol on sheath-magnitude fields)."""
    cfg, st, te = _setup(n=4000)
    st64 = jax.tree.map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, st)
    _, m = run(sheath.make_step(cfg), st64, 300)
    r = np.asarray(m.picard_residual, np.float64)
    # the loop converges below the absolute tol once the field develops
    # (the f32-floor bug exited at ~tol_floor * eps32 * ||es|| instead)
    assert (r[-100:] <= cfg.tol).all(), r[-100:].max()
