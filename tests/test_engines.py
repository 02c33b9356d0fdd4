"""Physics acceptance tests for the periodic engines.

The reference validates physics by eyeballing plot overlays of simulated E^2
against analytic growth/damping rates (pypic.py:598-614) and printing total
energy (pypic.py:573). Here the same invariants get hard numeric thresholds
(SURVEY.md §4): two-stream growth rate, Landau damping rate, and energy drift.
All engine states run in float32 — the accelerator-realistic precision.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN, M_ELECTRON
from pypic_tpu.grid import GridSpec
from pypic_tpu import initialize as init
from pypic_tpu.engines import explicit, implicit
from pypic_tpu.runner import run


def _growth_rate_from_energy(ee, dt, saturation_frac=0.5):
    """Estimate the exponential growth rate of a field-energy time series:
    from the pre-growth minimum (after the initial-perturbation transient
    decays) to the half-saturation crossing."""
    ee = np.asarray(ee, np.float64)
    i1 = int(np.argmax(ee > saturation_frac * ee.max()))
    i0 = int(np.argmin(ee[:i1]))
    assert i1 - i0 > 10, f"window too small: [{i0}, {i1}]"
    return np.log(ee[i1] / ee[i0]) / (2.0 * (i1 - i0) * dt)  # EE ~ exp(2 g t)


def _two_stream_setup(n=20_000, ng=64):
    density = 1e10
    te = 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(ng, 15.0 * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "two-stream", n, density, 1, 0.05, grid, te, te, seed=2
    )
    return grid, x, v, params


def _two_stream_dispersion_gamma(params):
    """Cold symmetric two-stream growth rate at the loaded k and drift.

    From 1 = (wp^2/2)[(w - k v0)^-2 + (w + k v0)^-2]:
    gamma^2/wp^2 = sqrt(1 + 8 x^2)/2 - x^2 - 1/2 with x = k v0 / wp.
    (The reference's growth_rate formula, pypic.py:444, is the weak-beam
    estimate applied at beam ratio 1 — outside its validity; the dispersion
    solution is the physically correct target. Warm beams damp it slightly.)
    """
    vte = params.v_thermal / np.sqrt(2.0)  # sqrt(kbTe/me)
    x = params.k * (2.0 * vte) / params.wp  # beam_drift = 2 vth (pypic.py:443)
    g2 = np.sqrt(1.0 + 8.0 * x * x) / 2.0 - x * x - 0.5
    assert g2 > 0, "chosen k is outside the unstable band"
    return params.wp * np.sqrt(g2)


def test_two_stream_growth_implicit():
    grid, x, v, params = _two_stream_setup()
    dt = 0.1 / params.wp
    cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-3, maxiter=20)
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    _, m = run(implicit.make_step(cfg), st, 400)
    gamma = _growth_rate_from_energy(m.field_energy, dt)
    ratio = gamma / _two_stream_dispersion_gamma(params)
    assert 0.6 < ratio < 1.3, f"growth ratio {ratio}"


def test_two_stream_growth_explicit():
    grid, x, v, params = _two_stream_setup()
    dt = 0.1 / params.wp
    cfg = explicit.ExplicitConfig(grid, dt, params.p2c)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    _, m = run(explicit.make_step(cfg), st, 400)
    gamma = _growth_rate_from_energy(m.field_energy, dt)
    ratio = gamma / _two_stream_dispersion_gamma(params)
    assert 0.6 < ratio < 1.3, f"growth ratio {ratio}"


def test_landau_damping_rate_implicit():
    """kLD = 0.5 textbook case: gamma = -0.153 wp, measured via the peak
    envelope of the field energy before the noise floor."""
    density = 1e10
    te = 1.0 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 4.0 * np.pi * debye, "periodic")
    n = 400_000
    x, v, params = init.initialize_periodic(
        "landau-damping", n, density, 1, 0.1, grid, te, te, seed=4
    )
    dt = 0.1 / params.wp
    cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-4, maxiter=20)
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    _, m = run(implicit.make_step(cfg), st, 160)
    ee = np.asarray(m.field_energy, np.float64)
    # peak envelope (E^2 oscillates at 2 w_pe)
    pk = [
        i
        for i in range(2, len(ee) - 2)
        if ee[i] > ee[i - 1] and ee[i] >= ee[i + 1] and ee[i] > 5 * ee.min()
    ]
    t = np.arange(len(ee)) * dt
    pk = [i for i in pk if t[i] * params.wp < 15.0]
    assert len(pk) >= 4
    gamma = np.polyfit(t[pk], np.log(ee[pk]), 1)[0] / 2.0
    ratio = gamma / params.growth_rate  # both negative
    assert 0.7 < ratio < 1.4, f"damping ratio {ratio}"


def test_implicit_energy_conservation():
    """The energy-conserving scheme at tight Picard tolerance holds total
    energy to <5e-5 over 2000 steps at float32 — 10x inside the
    <0.1%/1e4-step north-star pro-rated (BASELINE.md; bench.py measures the
    full 1e4-step criterion on the GPU). Drift is set by the Picard tolerance,
    not by float32 (measured: tol 1e-8 gives ~1.4e-6/2000 steps at f32)."""
    grid, x, v, params = _two_stream_setup(n=10_000, ng=64)
    dt = 0.1 / params.wp
    cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-8, maxiter=50)
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    _, m = run(implicit.make_step(cfg), st, 2000)
    tot = np.asarray(m.field_energy, np.float64) + np.asarray(
        m.kinetic_energy, np.float64
    )
    drift = abs(tot[-1] - tot[0]) / tot[0]
    assert drift < 5e-5, f"energy drift {drift}"


def test_picard_telemetry():
    """Iteration counts stay within the reference envelope (<= maxiter) and
    the residual meets tolerance in a well-resolved run."""
    grid, x, v, params = _two_stream_setup(n=5_000)
    dt = 0.05 / params.wp
    cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-3, maxiter=20)
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    _, m = run(implicit.make_step(cfg), st, 50)
    iters = np.asarray(m.picard_iters)
    assert iters.max() <= 20
    assert (np.asarray(m.picard_residual) <= 1e-3).all()


def test_explicit_vs_implicit_agree_early():
    """Before trajectories decorrelate, both schemes track the same field
    energy evolution."""
    grid, x, v, params = _two_stream_setup(n=20_000)
    dt = 0.05 / params.wp
    icfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-6, maxiter=40)
    ist = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, icfg)
    _, im = run(implicit.make_step(icfg), ist, 40)
    ecfg = explicit.ExplicitConfig(grid, dt, params.p2c)
    est = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, ecfg)
    _, em = run(explicit.make_step(ecfg), est, 40)
    a = np.asarray(im.field_energy)
    b = np.asarray(em.field_energy)
    np.testing.assert_allclose(a[5:], b[5:], rtol=0.3)


def test_charge_density_neutral_mean():
    """Deposited rho for the uniform-background periodic engine has mean
    q n0 (macroscopic charge density), and the Poisson solve neutralizes it."""
    grid, x, v, params = _two_stream_setup(n=20_000)
    dt = 0.1 / params.wp
    cfg = explicit.ExplicitConfig(grid, dt, params.p2c)
    st = explicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    _, m = run(explicit.make_step(cfg), st, 1)
    rho = np.asarray(m.rho[0], np.float64)
    expected_mean = -E_CHARGE * 1e10
    assert np.isclose(rho.mean(), expected_mean, rtol=1e-3)


def test_bump_on_tail_growth():
    """Weak-beam (1/6) bump-on-tail — the regime where the reference's
    analytic growth formula (pypic.py:433) is actually applicable; the loaded
    k sits slightly off-resonance (k v_b / wp = 0.84), reducing the measured
    rate below the on-resonance maximum."""
    from pypic_tpu import diagnostics

    density = 1e10
    te = 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 30.0 * debye, "periodic")
    x, v, params = init.initialize_periodic(
        "bump-on-tail", 100_000, density, 1, 0.05, grid, te, te, seed=6
    )
    dt = 0.1 / params.wp
    cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-6, maxiter=40)
    st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
    _, m = run(implicit.make_step(cfg), st, 300)
    ee = np.asarray(m.field_energy, np.float64)
    assert ee.max() > 50.0 * ee[:80].min(), "no instability growth"
    gamma = diagnostics.growth_rate_from_energy(ee, dt)
    ratio = gamma / params.growth_rate
    assert 0.4 < ratio < 1.4, f"growth ratio {ratio}"


def test_implicit_two_species_composed():
    """The gen-1 implicit engine mixes electrons and ions through per-particle
    q/m arrays (PIC_L.py:339); the composed backend supports that and the
    mixed plasma stays stable and conserves energy."""
    density = 1e10
    te = 0.1 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    grid = GridSpec(64, 15.0 * debye, "periodic")
    n = 20_000
    rng = np.random.default_rng(9)
    x = rng.uniform(0, grid.length, n)
    m_arr = np.where(np.arange(n) < n // 2, M_ELECTRON, 1836.0 * M_ELECTRON)
    q_arr = np.where(np.arange(n) < n // 2, -E_CHARGE, E_CHARGE)
    vth = np.sqrt(K_BOLTZMANN * te / m_arr)
    v = rng.normal(size=n) * vth
    p2c = grid.length * density / n
    dt = 0.1 * np.sqrt(E_CHARGE**2 * density / EPSILON_0 / M_ELECTRON) ** -1
    cfg = implicit.ImplicitConfig(grid, dt, p2c, tol=1e-8, maxiter=50,
                                  backend="composed")
    st = implicit.init_state(x, v, q_arr, m_arr, cfg)
    _, m = run(implicit.make_step(cfg), st, 500)
    ee = np.asarray(m.field_energy, np.float64)
    ke = np.asarray(m.kinetic_energy, np.float64)
    tot = ee + ke
    assert np.isfinite(tot).all()
    drift = abs(tot[-1] - tot[0]) / tot[0]
    assert drift < 1e-4, f"two-species energy drift {drift}"


def test_finalize_modes_agree_and_nodep_is_bit_exact():
    """finalize='converged' (deposit-free sweep) is trajectory-bit-exact
    with 'converged-deposit' (the deposit was diagnostic only); 'iterate'
    (the reference's last-iterate return, pypic.py:293-295) agrees to the
    Picard tolerance."""
    grid, x, v, params = _two_stream_setup(n=10_000, ng=64)
    dt = 0.1 / params.wp
    outs = {}
    for fin in ("converged", "converged-deposit", "iterate"):
        cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-10,
                                      maxiter=50, backend="fused",
                                      finalize=fin)
        st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
        outs[fin] = run(implicit.make_step(cfg), st, 100)
    s_nd, s_d, s_it = (outs[f][0] for f in
                       ("converged", "converged-deposit", "iterate"))
    np.testing.assert_array_equal(np.asarray(s_nd.p), np.asarray(s_d.p))
    np.testing.assert_array_equal(np.asarray(s_nd.v), np.asarray(s_d.v))
    np.testing.assert_array_equal(np.asarray(s_nd.e), np.asarray(s_d.e))
    ee_nd = np.asarray(outs["converged"][1].field_energy, np.float64)
    ee_it = np.asarray(outs["iterate"][1].field_energy, np.float64)
    np.testing.assert_allclose(ee_it, ee_nd, rtol=2e-3)
    # current_bias: the closed-form mean equals the deposit's mean up to
    # f32 reduction order (different summation trees)
    cb_nd = np.asarray(outs["converged"][1].current_bias, np.float64)
    cb_d = np.asarray(outs["converged-deposit"][1].current_bias, np.float64)
    np.testing.assert_allclose(cb_nd, cb_d, rtol=1e-3)


def test_picard_quadratic_init_and_anderson_same_fixed_point():
    """'extrapolate2' and Anderson(1) mixing reach the same fixed point at
    tight tolerance with no more iterations than the linear-extrapolated
    start — solver accelerants, not scheme changes."""
    grid, x, v, params = _two_stream_setup(n=10_000, ng=64)
    dt = 0.1 / params.wp
    runs = {}
    for label, kw in {
        "base": dict(picard_init="extrapolate"),
        "quad": dict(picard_init="extrapolate2"),
        "anderson": dict(picard_init="extrapolate", picard_accel="anderson"),
        "anderson2": dict(picard_init="extrapolate",
                          picard_accel="anderson2"),
    }.items():
        cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-10,
                                      maxiter=50, **kw)
        st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
        runs[label] = run(implicit.make_step(cfg), st, 200)[1]
    ee_b = np.asarray(runs["base"].field_energy, np.float64)
    for label in ("quad", "anderson", "anderson2"):
        ee = np.asarray(runs[label].field_energy, np.float64)
        np.testing.assert_allclose(ee, ee_b, rtol=2e-3)
        it = np.asarray(runs[label].picard_iters, np.float64)
        it_b = np.asarray(runs["base"].picard_iters, np.float64)
        assert it.mean() <= it_b.mean() + 0.1


def test_finalize_field_mean2_and_damped_same_fixed_point():
    """finalize_field='mean2' (finalize sweep gathers with the average of
    the last two Picard map outputs) and picard_accel='damped'
    (under-relaxed iterate) both converge to the same fixed point at tight
    tolerance — they change the finalize evaluation/iteration path, not the
    scheme. At a fixed iteration count (tol=1e-30, maxiter=4) mean2 must
    still produce a bounded, physical trajectory."""
    grid, x, v, params = _two_stream_setup(n=10_000, ng=64)
    dt = 0.1 / params.wp
    runs = {}
    for label, kw in {
        "base": dict(tol=1e-10, maxiter=50),
        "mean2": dict(tol=1e-10, maxiter=50, finalize_field="mean2"),
        "damped": dict(tol=1e-10, maxiter=50, picard_accel="damped"),
        "fixed4_mean2": dict(tol=1e-30, maxiter=4, finalize_field="mean2"),
    }.items():
        cfg = implicit.ImplicitConfig(grid, dt, params.p2c,
                                      picard_init="extrapolate",
                                      backend="fused", **kw)
        st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
        runs[label] = run(implicit.make_step(cfg), st, 200)[1]
    ee_b = np.asarray(runs["base"].field_energy, np.float64)
    for label in ("mean2", "damped"):
        ee = np.asarray(runs[label].field_energy, np.float64)
        np.testing.assert_allclose(ee, ee_b, rtol=2e-3)
    # the fixed-count mean2 run tracks the converged trajectory to a few
    # parts in 1e3 and conserves total energy at the percent level
    ee4 = np.asarray(runs["fixed4_mean2"].field_energy, np.float64)
    np.testing.assert_allclose(ee4, ee_b, rtol=5e-2)
    tot = ee4 + np.asarray(runs["fixed4_mean2"].kinetic_energy, np.float64)
    assert abs(tot[-1] / tot[0] - 1.0) < 1e-2
    with pytest.raises(ValueError):
        implicit.ImplicitConfig(grid, dt, params.p2c, finalize_field="nope")
    # finalize='iterate' has no finalize sweep: a non-default finalize_field
    # would be silently ignored, so the config rejects the combination
    with pytest.raises(ValueError, match="no finalize sweep"):
        implicit.ImplicitConfig(grid, dt, params.p2c, finalize="iterate",
                                finalize_field="aitken")


def test_picard_extrapolated_init_same_physics_fewer_iters():
    """picard_init='extrapolate' converges to the same fixed point (tight
    tol) with no more iterations than the reference start es0 = E0 — it is a
    solver accelerant, not a scheme change."""
    grid, x, v, params = _two_stream_setup(n=10_000, ng=64)
    dt = 0.1 / params.wp
    runs = {}
    for init in ("field", "extrapolate"):
        cfg = implicit.ImplicitConfig(grid, dt, params.p2c, tol=1e-10,
                                      maxiter=50, picard_init=init)
        st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
        runs[init] = run(implicit.make_step(cfg), st, 200)[1]
    ee_f = np.asarray(runs["field"].field_energy, np.float64)
    ee_x = np.asarray(runs["extrapolate"].field_energy, np.float64)
    np.testing.assert_allclose(ee_x, ee_f, rtol=2e-3)
    it_f = np.asarray(runs["field"].picard_iters, np.float64)
    it_x = np.asarray(runs["extrapolate"].picard_iters, np.float64)
    assert it_x.mean() <= it_f.mean()



def test_backend_validation_and_fused_scalar_qm_guard():
    """Config rejects backend typos (a misspelling used to silently select
    the composed last-iterate path); backend='fused' with per-particle q/m
    arrays raises a clear error instead of an opaque reshape failure deep
    in the kernel scalars pack."""
    grid, x, v, params = _two_stream_setup(n=2_000, ng=64)
    dt = 0.1 / params.wp
    with pytest.raises(ValueError, match="backend"):
        implicit.ImplicitConfig(grid, dt, params.p2c, backend="fuesd")
    cfg = implicit.ImplicitConfig(grid, dt, params.p2c, backend="fused")
    n = x.shape[0]
    st = implicit.init_state(
        x, v, np.full(n, -E_CHARGE), np.full(n, M_ELECTRON), cfg)
    with pytest.raises(ValueError, match="scalar q/m"):
        implicit.make_step(cfg)(st)


def test_finalize_field_mean2_single_iteration_equals_last():
    """At a one-iteration Picard exit there is only ONE map output, so
    'mean2' must finalize with it alone — averaging with the seed would
    bias the finalize field toward the (extrapolated) initial guess."""
    grid, x, v, params = _two_stream_setup(n=4_000, ng=64)
    dt = 0.1 / params.wp
    runs = {}
    for label in ("last", "mean2"):
        cfg = implicit.ImplicitConfig(
            grid, dt, params.p2c, tol=1e30, maxiter=50,
            picard_init="extrapolate", backend="fused",
            finalize_field=label)
        st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
        runs[label] = run(implicit.make_step(cfg), st, 20)
    assert int(np.asarray(runs["mean2"][1].picard_iters).max()) == 1
    np.testing.assert_array_equal(np.asarray(runs["mean2"][0].p),
                                  np.asarray(runs["last"][0].p))
    np.testing.assert_array_equal(np.asarray(runs["mean2"][0].v),
                                  np.asarray(runs["last"][0].v))


def test_finalize_field_map_and_aitken_same_fixed_point():
    """finalize_field='map' (raw last map output eh_k — the unique choice
    Ampere-consistent with the field advance that produced state.e) and
    'aitken' (scalar-secant Δ² extrapolation of the last three map outputs)
    converge to the same fixed point at tight tolerance. Sharp property:
    under picard_accel='none' the mixed iterate IS the map output, so
    'map' must match 'last' bit-exactly at ANY iteration count."""
    grid, x, v, params = _two_stream_setup(n=10_000, ng=64)
    dt = 0.1 / params.wp
    runs = {}
    for label, kw in {
        "base": dict(tol=1e-10, maxiter=50),
        "map": dict(tol=1e-10, maxiter=50, finalize_field="map"),
        "aitken": dict(tol=1e-10, maxiter=50, finalize_field="aitken"),
        "map_fixed4": dict(tol=1e-30, maxiter=4, finalize_field="map"),
        "aitken_fixed4": dict(tol=1e-30, maxiter=4, finalize_field="aitken"),
        "aitken_fixed4_and": dict(tol=1e-30, maxiter=4,
                                  finalize_field="aitken",
                                  picard_accel="anderson"),
    }.items():
        cfg = implicit.ImplicitConfig(grid, dt, params.p2c,
                                      picard_init="extrapolate",
                                      backend="fused", **kw)
        st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
        runs[label] = run(implicit.make_step(cfg), st, 200)
    ee_b = np.asarray(runs["base"][1].field_energy, np.float64)
    # accel='none': es <- eh each iteration, so 'map' == 'last' bit-exactly
    np.testing.assert_array_equal(np.asarray(runs["map"][0].p),
                                  np.asarray(runs["base"][0].p))
    np.testing.assert_array_equal(np.asarray(runs["map"][0].v),
                                  np.asarray(runs["base"][0].v))
    # tight-tol aitken: same fixed point (the Δ² correction -> 0 with the
    # residual)
    ee_a = np.asarray(runs["aitken"][1].field_energy, np.float64)
    np.testing.assert_allclose(ee_a, ee_b, rtol=2e-3)
    # fixed-count runs stay physical and conserve total energy at the
    # percent level on this short horizon
    for label in ("map_fixed4", "aitken_fixed4", "aitken_fixed4_and"):
        ee = np.asarray(runs[label][1].field_energy, np.float64)
        np.testing.assert_allclose(ee, ee_b, rtol=5e-2)
        tot = ee + np.asarray(runs[label][1].kinetic_energy, np.float64)
        assert abs(tot[-1] / tot[0] - 1.0) < 1e-2


def test_finalize_field_map_aitken_single_iteration_equals_last():
    """At a one-iteration Picard exit 'map' and 'aitken' both fall back to
    the single map output, which (accel='none') equals the final iterate —
    bit-exact with 'last'."""
    grid, x, v, params = _two_stream_setup(n=4_000, ng=64)
    dt = 0.1 / params.wp
    runs = {}
    for label in ("last", "map", "aitken"):
        cfg = implicit.ImplicitConfig(
            grid, dt, params.p2c, tol=1e30, maxiter=50,
            picard_init="extrapolate", backend="fused",
            finalize_field=label)
        st = implicit.init_state(x, v, -E_CHARGE, M_ELECTRON, cfg)
        runs[label] = run(implicit.make_step(cfg), st, 20)
    for label in ("map", "aitken"):
        assert int(np.asarray(runs[label][1].picard_iters).max()) == 1
        np.testing.assert_array_equal(np.asarray(runs[label][0].p),
                                      np.asarray(runs["last"][0].p))
        np.testing.assert_array_equal(np.asarray(runs[label][0].v),
                                      np.asarray(runs["last"][0].v))
