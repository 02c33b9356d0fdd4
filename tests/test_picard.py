"""The implicit engines' Picard pass (ops.picard): the plain XLA pass against
its definition and the composed step, every finalize mode against its
definition, and the Triton kernel in the Pallas interpreter against the XLA
pass. The kernel itself runs on the GPU only in the tests marked ``gpu``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pypic_tpu.ops import deposit, gather, histogram_add
from pypic_tpu.ops.picard import picard_finalize, picard_pass

QM, W, DT, DX = -0.3, 0.7, 0.1, 1.0


def _inputs(n, ng, seed=0, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(0, ng, n)
    ps = np.mod(p0 + 0.05 * rng.normal(size=n), ng)
    v0 = rng.normal(size=n)
    field = rng.normal(size=ng)
    return tuple(jnp.asarray(a, dtype) for a in (field, ps, p0, v0))


def _definition(field, ps, p0, v0, ng, periodic=True, lo=None, hi=None):
    """Gather, Crank-Nicolson push (pypic.py:261-272), written out."""
    if lo is not None:
        ps = jnp.clip(ps, lo, hi)
    e_p = gather(field, ps, periodic=periodic)
    p1 = p0 + (DT / DX) * v0 + 0.5 * QM * DT * (DT / DX) * e_p
    v1 = v0 + QM * DT * e_p
    return p1, v1


@pytest.mark.parametrize("ng", [64, 129, 200])
def test_xla_pass_matches_composed_body(ng):
    """One XLA Picard pass == one iteration of the composed step's body
    (implicit.step_composed): half-step position, full-step velocity and
    the half-step current deposit."""
    field, ps, p0, v0 = _inputs(5000, ng, dtype=jnp.float64)
    ph, v1, jh = picard_pass(field, ps, p0, v0, ng, qm=QM, w=W, dt=DT,
                             dx=DX, emit_v=True)
    p1, v1_ref = _definition(field, ps, p0, v0, ng)
    ph_ref = jnp.mod(0.5 * (p0 + p1), ng)
    jh_ref = deposit(ph_ref, W * 0.5 * (v0 + v1_ref), ng, periodic=True,
                     method="scatter")
    np.testing.assert_allclose(ph, ph_ref, rtol=0, atol=1e-12 * ng)
    np.testing.assert_allclose(v1, v1_ref, rtol=1e-13)
    np.testing.assert_allclose(jh, jh_ref, rtol=1e-11, atol=1e-12)
    # emit_v only adds the velocity
    ph2, jh2 = picard_pass(field, ps, p0, v0, ng, qm=QM, w=W, dt=DT, dx=DX)
    np.testing.assert_array_equal(ph2, ph)
    np.testing.assert_array_equal(jh2, jh)


@pytest.mark.parametrize("mode", ["converged", "converged-deposit",
                                  "slab"])
def test_finalize_matches_definition(mode):
    """picard_finalize: the final update from the converged field — wrapped
    (p1, v1) and, with w, the full-step current at p1 (pypic.py:274-279);
    on a bounded slab the positions come back raw and the deposit clamps."""
    ng = 96
    field, ps, p0, v0 = _inputs(4000, ng, dtype=jnp.float64)
    if mode == "slab":
        lo, hi = 3.0, ng - 4.0
        p1, v1, j1 = picard_finalize(field, ps, p0, v0, ng, qm=QM, dt=DT,
                                     dx=DX, w=W, lo=lo, hi=hi)
        p1_ref, v1_ref = _definition(field, ps, p0, v0, ng, periodic=False,
                                     lo=lo, hi=hi)
        j1_ref = deposit(jnp.clip(p1_ref, lo, hi), W * v1_ref, ng,
                         periodic=False, method="scatter")
    else:
        p1_ref, v1_ref = _definition(field, ps, p0, v0, ng)
        p1_ref = jnp.mod(p1_ref, ng)
        j1_ref = deposit(p1_ref, W * v1_ref, ng, periodic=True,
                         method="scatter")
        if mode == "converged":
            p1, v1 = picard_finalize(field, ps, p0, v0, ng, qm=QM, dt=DT,
                                     dx=DX)
            j1 = None
        else:
            p1, v1, j1 = picard_finalize(field, ps, p0, v0, ng, qm=QM,
                                         dt=DT, dx=DX, w=W)
    np.testing.assert_allclose(p1, p1_ref, rtol=0, atol=1e-12 * ng)
    np.testing.assert_allclose(v1, v1_ref, rtol=1e-13)
    if j1 is not None:
        np.testing.assert_allclose(j1, j1_ref, rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("finalize", ["converged", "converged-deposit",
                                      "iterate"])
def test_engine_finalize_modes_on_the_pass(finalize):
    """The implicit engine's finalize modes, on the shared pass, against
    their definitions: after one Picard iteration (maxiter=1) the step's
    (p1, v1) are the finalize sweep from the converged iterate — or, for
    'iterate', the iterate's own velocity with p1 = p0 + dt/dx (v0+v1)/2 —
    and state.j is the half-step current ('converged', 'iterate') or the
    full-step deposit at p1 ('converged-deposit')."""
    from pypic_tpu.constants import EPSILON_0
    from pypic_tpu.engines import implicit
    from pypic_tpu.grid import GridSpec
    from pypic_tpu.ops import smooth_periodic

    ng, n = 64, 3000
    grid = GridSpec(ng, float(ng), "periodic")
    rng = np.random.default_rng(3)
    x = rng.uniform(0, ng, n)
    v = rng.normal(size=n)
    q, m = -1e-12, 1e-10  # qm = -0.01: a gentle field response
    cfg = implicit.ImplicitConfig(grid, DT, 1.0, tol=1e-30, maxiter=1,
                                  finalize=finalize)
    st = implicit.init_state(x, v, q, m, cfg, dtype=jnp.float64)
    new, _ = implicit.make_step(cfg)(st)
    qm, w = q / m, q * cfg.p2c / DX
    es = smooth_periodic(st.e)
    ph, v1, jh = picard_pass(es, st.p, st.p, st.v, ng, qm=qm, w=w, dt=DT,
                             dx=DX, emit_v=True)
    e1 = st.e + (DT / EPSILON_0) * (jnp.mean(jh) - smooth_periodic(jh))
    np.testing.assert_allclose(new.e, e1, rtol=1e-12, atol=1e-12)
    if finalize == "iterate":
        p1 = jnp.mod(st.p + 0.5 * DT / DX * (st.v + v1), ng)
        j1 = jh
    else:
        ef = smooth_periodic(0.5 * (e1 + st.e))  # the one iterate es_1
        p1, v1, j1_dep = picard_finalize(ef, ph, st.p, st.v, ng, qm=qm,
                                         dt=DT, dx=DX, w=w)
        j1 = j1_dep if finalize == "converged-deposit" else jh
    np.testing.assert_allclose(new.p, p1, rtol=0, atol=1e-10)
    np.testing.assert_allclose(new.v, v1, rtol=1e-12)
    np.testing.assert_allclose(new.j, j1, rtol=1e-10, atol=1e-20)


@pytest.mark.parametrize("ng", [50, 200, 800, 1024])
def test_triton_pass_interpret_matches_xla(ng):
    """The Triton kernel (Pallas interpreter) == the XLA pass, at n not a
    multiple of the tile: positions and velocities to float32 rounding,
    the current to float32 summation order."""
    n = 2 * 1024 + 333
    args = _inputs(n, ng, seed=ng)
    kw = dict(qm=QM, w=W, dt=DT, dx=DX, emit_v=True)
    ref = picard_pass(*args, ng, **kw)
    out = picard_pass(*args, ng, impl="triton", interpret=True, **kw)
    eps = float(np.spacing(np.float32(ng)))
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=4 * eps)
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-6, atol=1e-6)
    scale = float(jnp.abs(ref[2]).max())
    np.testing.assert_allclose(out[2], ref[2], rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("with_deposit", [False, True])
def test_triton_finalize_interpret_matches_xla(with_deposit):
    ng, n = 200, 3000
    args = _inputs(n, ng, seed=7)
    kw = dict(qm=QM, dt=DT, dx=DX, w=W if with_deposit else None)
    ref = picard_finalize(*args, ng, **kw)
    out = picard_finalize(*args, ng, impl="triton", interpret=True, **kw)
    assert len(out) == len(ref) == (3 if with_deposit else 2)
    eps = float(np.spacing(np.float32(ng)))
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=4 * eps)
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-6, atol=1e-6)
    if with_deposit:
        scale = float(jnp.abs(ref[2]).max())
        np.testing.assert_allclose(out[2], ref[2], rtol=0,
                                   atol=1e-5 * scale)


def test_triton_pass_lowers_for_cuda():
    """The kernel lowers to Triton IR for an NVIDIA GPU without one: the
    indexed field loads and the atomic adds are accepted by the lowering."""
    sd = jax.ShapeDtypeStruct
    ng, n = 200, 100_000

    def f(field, ps, p0, v0):
        return picard_pass(field, ps, p0, v0, ng, qm=QM, w=W, dt=DT, dx=DX,
                           impl="triton")

    lowered = jax.jit(f).trace(
        sd((ng,), jnp.float32), *[sd((n,), jnp.float32)] * 3
    ).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "picard_pass_triton" in text


def test_pass_argument_checks():
    field, ps, p0, v0 = _inputs(100, 32)
    with pytest.raises(ValueError, match="periodic only"):
        picard_pass(field, ps, p0, v0, 32, qm=QM, w=W, dt=DT, dx=DX,
                    lo=0.0, hi=31.0, impl="triton")
    with pytest.raises(ValueError, match="scalar w"):
        picard_pass(field, ps, p0, v0, 32, qm=QM, w=jnp.ones(100), dt=DT,
                    dx=DX, impl="triton", interpret=True)
    with pytest.raises(ValueError, match="both lo and hi"):
        picard_pass(field, ps, p0, v0, 32, qm=QM, w=W, dt=DT, dx=DX, lo=0.0)
    with pytest.raises(ValueError, match="unknown Picard"):
        picard_pass(field, ps, p0, v0, 32, qm=QM, w=W, dt=DT, dx=DX,
                    impl="cuda")


def test_slab_pass_clamps_for_grid_work_only():
    """Bounded-slab geometry: the gather and the deposit see positions
    clamped to [lo, hi], while the returned half-step position stays raw
    (the domain engine counts excursions from it)."""
    ng = 40
    lo, hi = 2.0, 37.0
    field, _, _, _ = _inputs(1, ng, dtype=jnp.float64)
    p0 = jnp.asarray([0.5, 20.0, 39.2])
    ps = p0
    v0 = jnp.zeros(3, jnp.float64)
    w = jnp.asarray([1.0, 1.0, 0.0])  # a dead slot deposits nothing
    ph, jh = picard_pass(field, ps, p0, v0, ng, qm=QM, w=w, dt=DT, dx=DX,
                         lo=lo, hi=hi)
    e_p = gather(field, jnp.clip(ps, lo, hi), periodic=False)
    np.testing.assert_allclose(ph, p0 + 0.25 * QM * DT * DT * e_p,
                               rtol=1e-13)
    assert float(ph[0]) < lo  # raw, not clamped
    assert float(jh[2]) != 0.0  # deposited at the clamped position lo
    _, jh1 = picard_pass(field, ps, p0, v0 + 1.0, ng, qm=0.0, w=w, dt=DT,
                         dx=DX, lo=lo, hi=hi)
    assert float(jh1[2]) == pytest.approx(1.0)  # the clamped particle
    assert float(jh1.sum()) == pytest.approx(2.0)


def test_histogram_add_matches_bincount():
    rng = np.random.default_rng(0)
    nbins = 3200
    idx = jnp.asarray(rng.integers(0, nbins, 100_000), jnp.int32)
    vals = jnp.asarray(rng.uniform(0, 1, 100_000), jnp.float32)
    # masked rows contribute nothing
    vals = vals.at[::7].set(0.0)
    out = histogram_add(idx, vals, nbins)
    expect = np.bincount(np.asarray(idx), weights=np.asarray(vals),
                         minlength=nbins)
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_triton_pass_on_gpu_matches_xla(require_gpu):
    """On the card: the compiled Triton kernel against the XLA pass."""
    ng, n = 200, 1_000_003
    args = _inputs(n, ng, seed=11)
    kw = dict(qm=QM, w=W, dt=DT, dx=DX, emit_v=True)
    ref = jax.jit(lambda *a: picard_pass(*a, ng, **kw))(*args)
    out = jax.jit(lambda *a: picard_pass(*a, ng, impl="triton", **kw))(*args)
    eps = float(np.spacing(np.float32(ng)))
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=4 * eps)
    scale = float(jnp.abs(ref[2]).max())
    np.testing.assert_allclose(out[2], ref[2], rtol=0, atol=1e-4 * scale)
