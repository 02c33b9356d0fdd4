"""Tridiagonal solvers (jit-friendly, static shapes).

The reference assembles dense (ng, ng) Laplacians and calls scipy sparse
direct/iterative solvers (``sppla.spsolve`` pypic.py:379, ``sppla.inv``
PIC_L_DD.py:139, ``sppla.bicgstab`` pygcpic.py:1046). None of those exist
under jit; every Laplacian in this codebase is tridiagonal (possibly
plus a rank-1 correction), so the rebuild solves them with:

* ``solve_tridiag``: the Thomas algorithm as a ``lax.scan`` pair — exact,
  deterministic, O(ng) with tiny constants (ng is 40-800 in every reference
  config, pypic.py:851, pygcpic.py:1973).
* ``solve_tridiag_rank1``: Sherman-Morrison on top of Thomas for systems that
  are "tridiagonal + one extra entry": the Dirichlet-Neumann Laplacian's
  one-sided second-order last row (3, -4, 1) (pygcpic.py:958-978) and the
  periodic Newton Jacobian's wrap corners (PIC_L.py:149-176).

Diagonals are passed as equal-length (n,) arrays: ``dl[i] = A[i, i-1]``
(dl[0] ignored), ``d[i] = A[i, i]``, ``du[i] = A[i, i+1]`` (du[-1] ignored).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _affine_scan_multi(alpha, betas, reverse=False):
    """Evaluate x_i = alpha_i x_prev + beta_i via associative composition
    (a2, b2) o (a1, b1) = (a2 a1, a2 b1 + b2), x_start = 0 — for several
    right-hand sides SHARING alpha, each carried as its own (n,) array."""

    def combine(left, right):
        a1, b1 = left
        a2, b2 = right
        return a2 * a1, tuple(a2 * x + y for x, y in zip(b1, b2))

    _, xs = lax.associative_scan(
        combine, (alpha, tuple(betas)), reverse=reverse, axis=0
    )
    return xs


def _solve_tridiag_pscan(dl, d, du, b):
    """Thomas recurrences with O(log n)-depth associative scans.

    Forward elimination cp_i = du_i / (d_i - dl_i cp_{i-1}) is a Moebius
    transform of cp_{i-1}; composing the 2x2 homogeneous-coordinate matrices
    with per-combine max-abs normalization (cp is a projective ratio, so
    rescaling is exact) keeps the products bounded.

    The 2x2 products are carried as four (n,) arrays rather than one
    (n, 2, 2) array, so each combine is plain elementwise work on
    contiguous vectors. Fusing the cp and dp recurrences into one scan of
    3x3 matrices costs ~27 multiplies and 9 divides per combine against
    8 + 4 here, so it is not done.
    """
    squeeze = b.ndim == 1
    a = dl.at[0].set(0.0)
    tiny = jnp.finfo(d.dtype).tiny

    cols = (b,) if squeeze else tuple(b[:, j] for j in range(b.shape[1]))

    # cp via normalized projective scan: m_i = [[0, du_i], [-a_i, d_i]].
    m = (jnp.zeros_like(d), du, -a, d)

    def combine(x, y):
        x00, x01, x10, x11 = x
        y00, y01, y10, y11 = y
        p00 = y00 * x00 + y01 * x10  # apply x first, then y
        p01 = y00 * x01 + y01 * x11
        p10 = y10 * x00 + y11 * x10
        p11 = y10 * x01 + y11 * x11
        s = jnp.maximum(
            jnp.maximum(jnp.abs(p00), jnp.abs(p01)),
            jnp.maximum(jnp.abs(p10), jnp.abs(p11)),
        )
        s = jnp.maximum(s, tiny)
        return p00 / s, p01 / s, p10 / s, p11 / s

    _, p01, _, p11 = lax.associative_scan(combine, m, axis=0)
    cp = p01 / p11  # acting on [cp_{-1}=0, 1]

    cp_prev = jnp.concatenate([jnp.zeros((1,), cp.dtype), cp[:-1]])
    denom = d - a * cp_prev

    # dp_i = (b_i - a_i dp_{i-1}) / denom_i: affine in dp_{i-1}.
    dps = _affine_scan_multi(-a / denom, tuple(c / denom for c in cols))

    # back-substitution x_i = dp_i - cp_i x_{i+1}: affine, reversed.
    xs = _affine_scan_multi(-cp, dps, reverse=True)
    return xs[0] if squeeze else jnp.stack(xs, axis=1)


def solve_tridiag(dl, d, du, b, method: str = "auto"):
    """Solve a tridiagonal system A x = b.

    Args:
        dl: (n,) sub-diagonal, dl[0] unused.
        d: (n,) main diagonal.
        du: (n,) super-diagonal, du[-1] unused.
        b: (n,) or (n, k) right-hand side(s).
        method: 'thomas' (sequential lax.scan — exact, but one dependent
            step per row, so an ng=600 solve inside a Newton loop is a long
            serial chain), 'pscan' (the same recurrences
            evaluated with O(log n)-depth ``lax.associative_scan``: the
            cp recurrence is a Moebius transform composed as normalized
            projective 2x2 products; the dp and back-substitution
            recurrences are affine compositions), or 'auto'
            (``platform.tridiag_method``).

    Returns:
        x with the same shape as b.
    """
    if method == "auto":
        from ..platform import tridiag_method

        method = tridiag_method(d.shape[0])
    if method == "pscan":
        return _solve_tridiag_pscan(dl, d, du, b)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]

    def fwd(carry, xs):
        cp_prev, dp_prev = carry
        a_i, b_i, c_i, r_i = xs
        denom = b_i - a_i * cp_prev
        cp = c_i / denom
        dp = (r_i - a_i * dp_prev) / denom
        return (cp, dp), (cp, dp)

    zero_row = jnp.zeros_like(b[0])
    # First row: cp0 = du0/d0, dp0 = b0/d0 falls out of the same recurrence
    # with cp_prev = dp_prev = 0 and a_0 = 0.
    a = dl.at[0].set(0.0)
    (_, _), (cp, dp) = lax.scan(
        fwd,
        (jnp.zeros((), d.dtype), zero_row),
        (a, d, du, b),
    )

    def bwd(x_next, xs):
        cp_i, dp_i = xs
        x_i = dp_i - cp_i * x_next
        return x_i, x_i

    _, xs_rev = lax.scan(bwd, zero_row, (cp, dp), reverse=True)
    x = xs_rev
    return x[:, 0] if squeeze else x


def solve_tridiag_rank1(dl, d, du, b, u, v):
    """Solve (T + u v^T) x = b with T tridiagonal, via Sherman-Morrison.

    x = y - z (v.y) / (1 + v.z) with y = T^{-1} b, z = T^{-1} u.
    """
    rhs = jnp.stack([b, u], axis=-1)
    yz = solve_tridiag(dl, d, du, rhs)
    y, z = yz[:, 0], yz[:, 1]
    denom = 1.0 + jnp.dot(v, z)
    return y - z * (jnp.dot(v, y) / denom)


def solve_cyclic_tridiag(dl, d, du, b, corner_ul, corner_lr):
    """Solve a tridiagonal system with wrap corners A[0,-1], A[-1,0].

    ``corner_ul`` is A[0, n-1] and ``corner_lr`` is A[n-1, 0] (both 1.0 for
    the reference's periodic Laplacians, pypic.py:347-355). The matrix must be
    nonsingular (the *pure* periodic Laplacian is singular — linear periodic
    Poisson solves go through the FFT path in pypic_tpu.ops.poisson instead;
    this function serves Newton Jacobians J = A + D which are strictly
    diagonally dominated by the Boltzmann term, PIC_L.py:162-172).
    """
    n = d.shape[0]
    gamma = -d[0]
    dmod = d.at[0].add(-gamma).at[n - 1].add(-corner_lr * corner_ul / gamma)
    u = jnp.zeros_like(d).at[0].set(gamma).at[n - 1].set(corner_lr)
    v = jnp.zeros_like(d).at[0].set(1.0).at[n - 1].set(corner_ul / gamma)
    return solve_tridiag_rank1(dl, dmod, du, b, u, v)
