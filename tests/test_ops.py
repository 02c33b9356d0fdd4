"""Unit tests for the L1/L2 grid kernels: CIC gather/deposit, finite
differences, tridiagonal and Poisson solvers.

Mirrors and extends the reference's doctest checks (pygcpic.py doctests,
SURVEY.md §4) with numpy ground truth.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pypic_tpu.ops import (
    gather,
    deposit,
    smooth_periodic,
    smooth_bounded,
    grad_periodic,
    grad_neg_bounded,
    integrate_neg_trapz,
    solve_tridiag,
    solve_tridiag_rank1,
    solve_cyclic_tridiag,
    solve_periodic_neutralized,
    solve_dirichlet,
    solve_boltzmann_dirichlet,
    solve_boltzmann_dirichlet_neumann,
)
from pypic_tpu.ops.cic import _deposit_scatter, _deposit_matmul
from pypic_tpu.constants import E_CHARGE, EPSILON_0, K_BOLTZMANN


def _ref_deposit(p, val, ng, periodic):
    out = np.zeros(ng)
    for i in range(len(p)):
        il = int(np.floor(p[i]))
        wr = p[i] - il
        ir = (il + 1) % ng if periodic else il + 1
        out[il] += val[i] * (1 - wr)
        out[ir] += val[i] * wr
    return out


@pytest.mark.parametrize("periodic,ng", [(True, 200), (True, 129), (False, 51), (False, 800)])
@pytest.mark.parametrize("method", ["scatter", "matmul"])
def test_deposit_matches_reference_loop(periodic, ng, method):
    rng = np.random.default_rng(3)
    n = 4000
    cells = ng if periodic else ng - 1
    p = rng.uniform(0, cells, n)
    val = rng.normal(size=n)
    ref = _ref_deposit(p, val, ng, periodic)
    got = deposit(
        jnp.asarray(p, jnp.float64), jnp.asarray(val, jnp.float64), ng,
        periodic=periodic, method=method,
    )
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-9, atol=1e-9)


def test_deposit_methods_agree_float32():
    rng = np.random.default_rng(5)
    ng, n = 300, 100_000
    p = jnp.asarray(rng.uniform(0, ng, n), jnp.float32)
    val = jnp.asarray(rng.normal(size=n), jnp.float32)
    a = _deposit_scatter(p, val, ng, True)
    b = _deposit_matmul(p, val, ng, True, 8192)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-3)


def test_deposit_conserves_charge():
    rng = np.random.default_rng(7)
    ng, n = 128, 10_000
    p = jnp.asarray(rng.uniform(0, ng, n))
    val = jnp.ones(n)
    for method in ("scatter", "matmul"):
        out = deposit(p, val, ng, periodic=True, method=method)
        np.testing.assert_allclose(float(jnp.sum(out)), n, rtol=1e-5)


def test_gather_deposit_adjoint():
    """<deposit(p, v), F> == <v, gather(F, p)> — CIC scatter and gather are
    exact adjoints (the property that makes the scheme momentum-conserving)."""
    rng = np.random.default_rng(11)
    ng, n = 64, 500
    p = jnp.asarray(rng.uniform(0, ng, n), jnp.float64)
    v = jnp.asarray(rng.normal(size=n), jnp.float64)
    f = jnp.asarray(rng.normal(size=ng), jnp.float64)
    lhs = float(jnp.dot(deposit(p, v, ng, periodic=True, method="scatter"), f))
    rhs = float(jnp.dot(v, gather(f, p, periodic=True)))
    assert abs(lhs - rhs) < 1e-9 * max(abs(lhs), 1.0)


def test_gather_linear_field_exact():
    """CIC interpolation reproduces a linear field exactly (bounded grid)."""
    ng = 33
    f = jnp.linspace(0.0, 1.0, ng).astype(jnp.float64)
    p = jnp.asarray(np.random.default_rng(0).uniform(0, ng - 1, 100))
    got = gather(f, p, periodic=False)
    np.testing.assert_allclose(np.asarray(got), np.asarray(p) / (ng - 1), atol=1e-12)


def test_single_particle_weighting_doctest():
    """pygcpic.py:852-866: particle at x=0 puts p2c/dx on node 0; at
    L - dx/2 it puts half on the last node."""
    ng, length, p2c = 101, 1.0, 1.0
    dx = length / (ng - 1)
    w = jnp.asarray([p2c / dx])
    n = deposit(jnp.asarray([0.0]), w, ng, periodic=False, method="scatter")
    assert np.isclose(float(n[0]), 100.0)
    p_last = jnp.asarray([(length - dx / 2) / dx])
    n2 = deposit(p_last, w, ng, periodic=False, method="scatter")
    assert np.isclose(float(n2[-1]), 50.0)


def test_smoothers():
    f = np.random.default_rng(1).normal(size=40)
    s = np.asarray(smooth_periodic(jnp.asarray(f)))
    np.testing.assert_allclose(s, (np.roll(f, -1) + 2 * f + np.roll(f, 1)) / 4)
    sb = np.asarray(smooth_bounded(jnp.asarray(f)))
    assert sb[0] == f[0] and sb[-1] == f[-1]
    np.testing.assert_allclose(sb[1:-1], s[1:-1])


def test_grad_neg_bounded_doctest():
    """pygcpic.py:921-930: constant phi -> E = 0; linear phi -> uniform E."""
    phi = jnp.ones(6)
    np.testing.assert_allclose(np.asarray(grad_neg_bounded(phi, 1.0)), 0.0)
    phi = jnp.linspace(0.0, 1.0, 6)
    e = np.asarray(grad_neg_bounded(phi, 1.0))
    np.testing.assert_allclose(e, -0.2, rtol=1e-6)


def test_integrate_neg_trapz_matches_numpy():
    f = np.random.default_rng(2).normal(size=50)
    dx = 0.3
    ref = np.array([-np.trapezoid(f[: i + 1], dx=dx) for i in range(50)])
    got = np.asarray(integrate_neg_trapz(jnp.asarray(f), dx))
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_thomas_and_rank1_and_cyclic():
    rng = np.random.default_rng(4)
    n = 97
    dl = rng.normal(size=n)
    d = rng.normal(size=n) + 5.0
    du = rng.normal(size=n)
    a = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    b = rng.normal(size=n)
    x = np.asarray(solve_tridiag(jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du), jnp.asarray(b)))
    np.testing.assert_allclose(a @ x, b, atol=1e-9)

    u = np.zeros(n); u[-1] = 1.0
    v = np.zeros(n); v[-3] = 1.0
    x2 = np.asarray(solve_tridiag_rank1(
        jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du), jnp.asarray(b),
        jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose((a + np.outer(u, v)) @ x2, b, atol=1e-9)

    ac = a.copy(); ac[0, -1] = 1.0; ac[-1, 0] = 1.0
    x3 = np.asarray(solve_cyclic_tridiag(
        jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du), jnp.asarray(b), 1.0, 1.0))
    np.testing.assert_allclose(ac @ x3, b, atol=1e-9)


def test_periodic_poisson_matches_dense_lstsq():
    rng = np.random.default_rng(0)
    ng, dx = 200, 0.1
    rho = rng.normal(size=ng)
    a = (np.diag(-2 * np.ones(ng)) + np.diag(np.ones(ng - 1), 1)
         + np.diag(np.ones(ng - 1), -1))
    a[0, -1] = 1.0
    a[-1, 0] = 1.0
    b = -(dx * dx) * (rho - rho.mean()) / EPSILON_0
    phi_ref = np.linalg.lstsq(a, b, rcond=None)[0]
    phi = np.asarray(solve_periodic_neutralized(jnp.asarray(rho), dx))
    e_ref = -(np.roll(phi_ref, -1) - np.roll(phi_ref, 1)) / (2 * dx)
    e = -(np.roll(phi, -1) - np.roll(phi, 1)) / (2 * dx)
    np.testing.assert_allclose(e, e_ref, rtol=1e-6, atol=1e-6 * np.abs(e_ref).max())


def test_dirichlet_poisson_doctest():
    """pygcpic.py:991-996: rho = ones, dx=1 on 5 nodes -> [0, 1.5, 2, 1.5, 0]."""
    phi = np.asarray(solve_dirichlet(jnp.ones(5), 1.0))
    np.testing.assert_allclose(phi, [0.0, 1.5, 2.0, 1.5, 0.0], atol=1e-6)


def test_boltzmann_dirichlet_neutral_plasma():
    """pygcpic.py:1010-1019: a perfectly neutral plasma gives phi == 0."""
    res = solve_boltzmann_dirichlet(
        jnp.ones(5), 1.0 / E_CHARGE, 1.0 / K_BOLTZMANN, 1.0)
    np.testing.assert_allclose(np.asarray(res.phi), 0.0, atol=1e-10)


def test_boltzmann_dirichlet_neumann_neutral_plasma():
    """pygcpic.py:1067-1076 analog."""
    n0 = 1.0 / E_CHARGE * EPSILON_0
    res = solve_boltzmann_dirichlet_neumann(
        jnp.full(5, n0), n0, 1.0 / K_BOLTZMANN, 1.0, jnp.zeros(5))
    np.testing.assert_allclose(np.asarray(res.phi), 0.0, atol=1e-8)


def test_boltzmann_dirichlet_converges_on_sheath_profile():
    """Physical check: a uniform ion density with Boltzmann electrons forms a
    positive mid-plane potential (a sheath), and the Newton residual meets
    tolerance within the reference envelope (pygcpic.py:1022-1023)."""
    density = 1e16
    te = 10.0 * 11600.0
    debye = np.sqrt(K_BOLTZMANN * te * EPSILON_0 / E_CHARGE**2 / density)
    ng = 101
    length = 40 * debye
    dx = length / (ng - 1)
    rho = jnp.full(ng, E_CHARGE * density)
    res = solve_boltzmann_dirichlet(rho, 0.9 * density, te, dx)
    phi = np.asarray(res.phi)
    assert int(res.iterations) < 1000
    assert float(res.residual) <= 1e-9
    assert phi[ng // 2] > 0.0
    assert phi[0] == pytest.approx(0.0, abs=1e-6) or phi[-1] == pytest.approx(0.0, abs=1e-6)
    # symmetric problem -> symmetric potential
    np.testing.assert_allclose(phi, phi[::-1], rtol=1e-3, atol=1e-6 * phi.max())


def test_pscan_tridiag_matches_thomas():
    """The O(log n) associative-scan tridiagonal path ('pscan') matches
    the sequential Thomas path, including f32 at Boltzmann-Jacobian scales."""
    rng = np.random.default_rng(4)
    for n in (97, 600):
        dl = rng.normal(size=n)
        d = rng.normal(size=n) + 5.0
        du = rng.normal(size=n)
        a = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
        b = rng.normal(size=n)
        x = np.asarray(solve_tridiag(
            jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du), jnp.asarray(b),
            method="pscan"))
        np.testing.assert_allclose(a @ x, b, atol=1e-9)
    # float32 with a large negative diagonal (Newton-Boltzmann regime)
    n = 600
    dl = np.ones(n)
    du = np.ones(n)
    d = -2.0 - 1e8 * np.abs(rng.normal(size=n))
    b = rng.normal(size=n) * 1e8
    a = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    x32 = np.asarray(solve_tridiag(
        jnp.asarray(dl, jnp.float32), jnp.asarray(d, jnp.float32),
        jnp.asarray(du, jnp.float32), jnp.asarray(b, jnp.float32),
        method="pscan"))
    xref = np.linalg.solve(a, b)
    assert np.abs(x32 - xref).max() / np.abs(xref).max() < 1e-5


def test_bounded_cic_particle_exactly_at_last_node():
    """A particle exactly at the last node (p == num_cells, valid on bounded
    grids where the wall check is strict) deposits with full weight on that
    node with every deposit method and in float32 as in float64 — the
    scatter path used to displace it one cell left (weights computed
    before index clipping)."""
    ng = 200
    for dtype in (jnp.float64, jnp.float32):
        p = jnp.asarray([199.0], dtype)
        val = jnp.asarray([1.0], dtype)
        for method in ("scatter", "matmul"):
            out = np.asarray(deposit(p, val, ng, periodic=False,
                                     method=method))
            assert np.isclose(out[199], 1.0), (method, dtype)
            assert np.isclose(out.sum(), 1.0), (method, dtype)
    p = jnp.asarray([199.0])
    f = jnp.arange(ng, dtype=jnp.float64)
    g = np.asarray(gather(f, p, periodic=False, method="take"))
    assert np.isclose(g[0], 199.0)


def test_anderson_m_accelerates_linear_map():
    """anderson_m_mix on a linear contraction x -> Ax + b behaves like
    GMRES on the fixed-point residual: depth-5 reaches a far smaller
    residual than the Anderson(1) secant in the same iteration budget, and
    the safeguards (finite-guard + trust region) never emit non-finite
    iterates. Depths > 2 are reachable from the engines via
    picard_accel='anderson5' (accel.anderson_depth)."""
    import numpy as np
    from pypic_tpu.ops.accel import (
        anderson_depth,
        anderson_m_mix,
        anderson_mix,
        mix_init,
    )

    assert anderson_depth("anderson5") == 5
    assert anderson_depth("anderson2") is None  # dedicated impl
    assert anderson_depth("none") is None

    rng = np.random.default_rng(0)
    dim = 51
    q = rng.normal(size=(dim, dim))
    a = 0.97 * q @ np.diag(rng.uniform(-1, 1, dim)) @ np.linalg.inv(q)
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(rng.normal(size=dim), jnp.float32)

    def iterate(mode, mix, iters=25):
        es = jnp.zeros(dim, jnp.float32)
        aux = mix_init(es, mode)
        res = None
        for k in range(iters):
            eh = a @ es + b
            res = float(jnp.linalg.norm(eh - es))
            es, aux = mix(es, eh, k, aux)
            assert bool(jnp.all(jnp.isfinite(es))), (mode, k)
        return res

    r1 = iterate("anderson", lambda es, eh, k, aux:
                 anderson_mix(es, eh, k, aux))
    r5 = iterate("anderson5", lambda es, eh, k, aux:
                 anderson_m_mix(es, eh, k, aux, 5))
    assert r5 < r1 * 1e-2, (r5, r1)

