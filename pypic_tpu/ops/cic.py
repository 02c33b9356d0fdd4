"""Cloud-in-cell (CIC / linear) gather and deposit.

These are the L1 grid kernels of the reference, rebuilt for JAX:

* gather (grid -> particle interpolation): reference ``interpolate_p``
  (pypic.py:28-61), ``interpolateField`` (PIC_L_DD.py:32-39),
  ``Particle.interpolate_electric_field_dirichlet`` (pygcpic.py:325-348).
* deposit (particle -> grid weighting): reference ``weight_current_p`` /
  ``weight_density_p`` (pypic.py:91-183), ``weightCurrents`` /
  ``weightDensities`` (PIC_L_DD.py:41-88),
  ``Grid.weight_particles_to_grid_boltzmann`` (pygcpic.py:841-905).

The reference deposits with a sequential per-particle ``j[ind] += ...`` loop
(pypic.py:130-133). Two structural reworks are provided:

1. ``method='scatter'``: XLA scatter-add (``.at[].add``). On a GPU XLA lowers
   it to atomic adds, whose order (and so the last bits of the sum) varies
   from run to run; on the CPU it is deterministic.
2. ``method='matmul'``: particles are processed in fixed chunks; each
   particle's two CIC weights are expressed as a *tent function*
   ``max(0, 1 - |p - g|)`` evaluated over a 128-node window of grid nodes, so a
   chunk becomes a dense (chunk, 128) matrix and the reduction over particles
   becomes a matrix product against a (chunk, K) window-selector one-hot,
   taken at HIGHEST precision. Windows are strided by 127 so a particle's two
   adjacent cells never straddle a window boundary. The per-window
   accumulator (K, 128) is folded back onto the ng nodes with a tiny
   O(K*128) scatter. Its reduction order is fixed.

``method='auto'`` asks ``pypic_tpu.platform.deposit_method``.

All positions are grid coordinates p = x/dx (see pypic_tpu.grid).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

LANE = 128
WINDOW = LANE - 1  # stride-127 windows: cells c and c+1 share a window
_DEFAULT_CHUNK = 1 << 16


def cic_indices_weights(p, num_cells: int, periodic: bool):
    """Left/right node indices and weights for positions p (grid coords).

    Matches the reference weighting exactly: ``index_L = floor(p)``,
    ``w_R = p - floor(p)``, ``w_L = 1 - w_R`` (pypic.py:47-53). For periodic
    grids the right node wraps (pypic.py:49); for bounded grids node
    ``idx_l + 1`` is clipped to the last node (where w_r contributions at the
    clip point are zero for in-domain particles).
    """
    # Clip the cell index BEFORE computing weights so a particle exactly at
    # the last node (p == num_cells, valid on bounded grids where the wall
    # check is strict, e.g. pygcpic.py:685 `> grid.length`) lands with full
    # weight on that node (w_r = 1 toward idx_r) instead of being displaced
    # one cell left — and stays consistent with the tent-kernel paths.
    idx_l = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, num_cells - 1)
    w_r = p - idx_l.astype(p.dtype)
    w_l = 1.0 - w_r
    if periodic:
        idx_r = jnp.where(idx_l + 1 >= num_cells, 0, idx_l + 1)
    else:
        idx_r = jnp.clip(idx_l + 1, 0, num_cells)
    return idx_l, idx_r, w_l, w_r


def gather(field, p, *, periodic: bool, method: str = "auto"):
    """Interpolate a node field to particle positions (CIC).

    Args:
        field: (ng,) field values on nodes.
        p: (n,) particle positions in grid coordinates.
        periodic: wrap the right neighbour node.
        method: 'take' (XLA gather); 'auto' is the same.

    Returns:
        (n,) interpolated values.
    """
    if method not in ("auto", "take"):
        raise ValueError(f"unknown gather method {method!r}")
    num_cells = field.shape[0] if periodic else field.shape[0] - 1
    idx_l, idx_r, w_l, w_r = cic_indices_weights(p, num_cells, periodic)
    return jnp.take(field, idx_l) * w_l + jnp.take(field, idx_r) * w_r


def _deposit_scatter(p, values, ng: int, periodic: bool):
    num_cells = ng if periodic else ng - 1
    idx_l, idx_r, w_l, w_r = cic_indices_weights(p, num_cells, periodic)
    out = jnp.zeros((ng,), dtype=values.dtype)
    out = out.at[idx_l].add(values * w_l)
    out = out.at[idx_r].add(values * w_r)
    return out


def _num_windows(ng: int) -> int:
    # window k covers global cells [k*127, k*127 + 127]; the rightmost needed
    # node index is ng - 1 for bounded, ng (wrap slot) for periodic; ng covers
    # both since tent support of p <= num_cells reaches node num_cells.
    return (ng + WINDOW - 1) // WINDOW


def _deposit_matmul(p, values, ng: int, periodic: bool, chunk: int):
    n = p.shape[0]
    num_k = _num_windows(ng)
    dtype = values.dtype

    pad = (-n) % chunk
    if pad:
        p = jnp.concatenate([p, jnp.zeros((pad,), p.dtype)])
        values = jnp.concatenate([values, jnp.zeros((pad,), dtype)])
    nb = p.shape[0] // chunk
    p_b = p.reshape(nb, chunk)
    v_b = values.reshape(nb, chunk)

    cols = jnp.arange(LANE, dtype=p.dtype)
    kids = jnp.arange(num_k, dtype=jnp.int32)

    def body(acc, args):
        pc, vc = args
        cell = jnp.floor(pc)
        k = jnp.clip((cell * (1.0 / WINDOW)).astype(jnp.int32), 0, num_k - 1)
        d = pc - k.astype(pc.dtype) * WINDOW  # in [0, 127)
        tent = jnp.maximum(0.0, 1.0 - jnp.abs(d[:, None] - cols[None, :]))
        m = tent * vc[:, None]  # (chunk, 128)
        sel = (k[:, None] == kids[None, :]).astype(dtype)  # (chunk, K)
        # HIGHEST: a GPU may otherwise run the float32 product in TF32
        acc = acc + jax.lax.dot_general(
            sel, m, (((0,), (0,)), ((), ())), preferred_element_type=dtype,
            precision=lax.Precision.HIGHEST,
        )
        return acc, None

    acc0 = jnp.zeros((num_k, LANE), dtype=dtype)
    acc, _ = lax.scan(body, acc0, (p_b, v_b))

    # Fold the (K, 128) window accumulator onto the ng nodes: window k slot l
    # is global node k*127 + l; overlapping slots (l=127 of window k == l=0 of
    # window k+1) and the periodic wrap slot (node == ng) fold additively.
    g = (kids[:, None] * WINDOW + jnp.arange(LANE, dtype=jnp.int32)[None, :]).reshape(-1)
    flat = acc.reshape(-1)
    if periodic:
        g = g % ng
    else:
        flat = jnp.where(g < ng, flat, 0.0)
        g = jnp.minimum(g, ng - 1)
    return jnp.zeros((ng,), dtype=dtype).at[g].add(flat)


def histogram_add(idx, values, nbins: int, *, method: str = "auto"):
    """Weighted histogram of integer bin indices — as a CIC deposit.

    A histogram is a width-0 tent deposit: with exactly-integer positions the
    right-node CIC weight is identically zero, so it is a ``deposit`` with the
    same choice of method. Used for the IEAD wall-impact histograms
    (pygcpic.py:1259-1262) and the exit-velocity histograms (the rebuild's
    form of PIC_L_DD.py:495-504).

    Args:
        idx: (n,) int bin indices, already clipped to [0, nbins - 1].
        values: (n,) weights (0 for masked-out rows).
        nbins: number of bins.
    """
    return deposit(
        idx.astype(values.dtype), values, nbins, periodic=False, method=method
    )


def deposit(
    p,
    values,
    ng: int,
    *,
    periodic: bool,
    method: str = "auto",
    chunk: int = _DEFAULT_CHUNK,
):
    """CIC-deposit per-particle values onto ng grid nodes.

    ``values`` must already include all physical prefactors (e.g.
    ``q * v * p2c / dx`` for current density, pypic.py:121) and must be zero
    for masked-out (inactive) particles — masking by value is how the rebuild
    replaces the reference's ``if active[i] == 1`` deposit guards
    (PIC_L_DD.py:50-54).

    Args:
        p: (n,) positions in grid coordinates.
        values: (n,) deposit values.
        ng: number of field nodes.
        periodic: periodic node wrap vs bounded grid.
        method: 'scatter' | 'matmul' | 'auto' (``platform.deposit_method``).

    Returns:
        (ng,) deposited field.
    """
    if method == "auto":
        from ..platform import deposit_method

        method = deposit_method(p.shape[0], ng)
    if method == "scatter":
        return _deposit_scatter(p, values, ng, periodic)
    if method == "matmul":
        return _deposit_matmul(p, values, ng, periodic, chunk)
    raise ValueError(f"unknown deposit method {method!r}")
