"""The fused Picard pass of the implicit engines, and its finalize sweep.

One Picard iteration of the Crank-Nicolson particle update (pypic.py:253-279)
is a single pass over the particles: gather the smoothed field guess at the
position guess (pypic.py:261), push (pypic.py:264-265), and deposit the
half-step current at the half-step position (pypic.py:267-272). Both
implicit engines run it every iteration, and it is the whole cost of their
step at scale.

``picard_pass`` and ``picard_finalize`` work on flat ``(n,)`` particle arrays
in one of two geometries:

* periodic (``lo is None``): positions in [0, ng), the field and the current
  live on the ng periodic nodes, half-step and final positions come back
  wrapped;
* bounded slab (``lo``/``hi`` given): the domain-decomposed engine's
  halo-extended slab of ng nodes. Positions are clamped to [lo, hi] for grid
  work only and come back raw, so the caller can count excursions; ``w`` is
  per particle (zero for dead slots).

Two implementations, chosen by ``impl`` (see ``pypic_tpu.platform``):

* ``'xla'`` — plain ``jnp``: ``ops.cic.gather`` (``jnp.take``), the push,
  and ``ops.cic.deposit`` (scatter-add, or the tent-matrix product with
  ``method='matmul'``). It is the reference for the kernel below and what
  runs on every platform.
* ``'triton'`` — one Pallas kernel compiled through Triton for NVIDIA GPUs,
  periodic geometry only. Each program walks ``_TILES`` tiles of ``_TILE``
  particles, gathers by indexed loads from the (L1-resident) field, pushes
  in registers, and adds the current into its own row of a zeroed
  ``(programs, ng_pad)`` buffer with atomics, so contention stays inside a
  program. One XLA sum over the rows gives the current. Atomics add in no
  fixed order, so the kernel's current agrees with the XLA pass to float32
  rounding, not bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .cic import deposit, gather

_TILE = 1024  # particles per tile (a power of two, as Triton requires)
_TILES = 32  # tiles each program walks
_NUM_WARPS = 4


def _wrap(p, ng: int):
    """Periodic wrap into [0, ng) (pypic.py:270, 277)."""
    return p - jnp.floor(p * (1.0 / ng)) * ng


def _coefficients(qm, dt: float, dx: float):
    """(qm dt, qm dt^2 / (2 dx), dt/dx): the CN update in grid coordinates,
    p1 = p0 + (dt/dx) v0 + b e_p, v1 = v0 + a e_p (pypic.py:264-265)."""
    a = qm * dt
    return a, a * (0.5 * dt / dx), dt / dx


def _push_xla(field, ps, p0, v0, qm, dt, dx, lo, hi):
    periodic = lo is None
    if not periodic:
        ps = jnp.clip(ps, lo, hi)
    e_p = gather(field, ps, periodic=periodic)
    a, b, dt_dx = _coefficients(qm, dt, dx)
    return p0 + dt_dx * v0 + b * e_p, v0 + a * e_p


def _check_geometry(lo, hi, impl):
    if (lo is None) != (hi is None):
        raise ValueError("give both lo and hi (bounded slab) or neither")
    if impl not in ("xla", "triton"):
        raise ValueError(f"unknown Picard implementation {impl!r}")
    if impl == "triton" and lo is not None:
        raise ValueError("the Triton Picard pass is periodic only; "
                         "bounded slabs run impl='xla'")


def picard_pass(field, ps, p0, v0, ng: int, *, qm, w, dt: float, dx: float,
                emit_v: bool = False, lo=None, hi=None, impl: str = "xla",
                method: str = "scatter", interpret: bool = False):
    """One Picard iteration over the particles.

    Args:
        field: (ng,) smoothed field guess on the nodes.
        ps: (n,) position guess (grid coordinates) the field is gathered at.
        p0, v0: (n,) start-of-step positions and velocities.
        ng: number of nodes of ``field`` and of the returned current.
        qm: charge-to-mass ratio (scalar).
        w: deposit prefactor q p2c / dx (scalar, or (n,) on a slab).
        emit_v: also return the iterate's full-step velocity v1.
        lo, hi: clamp bounds of the bounded-slab geometry (see module doc).
        impl: 'xla' or 'triton'.
        method: deposit method of the 'xla' implementation.
        interpret: run the Triton kernel in the Pallas interpreter (tests).

    Returns:
        (ph, jh) or, with ``emit_v``, (ph, v1, jh): the half-step positions
        (the next position guess) and the (ng,) half-step current.
    """
    _check_geometry(lo, hi, impl)
    if impl == "triton":
        return _triton_call(field, ps, p0, v0, ng, qm=qm, w=w, dt=dt, dx=dx,
                            final=False, emit_v=emit_v, deposit_j=True,
                            interpret=interpret)
    p1, v1 = _push_xla(field, ps, p0, v0, qm, dt, dx, lo, hi)
    ph = 0.5 * (p0 + p1)
    vals = w * (0.5 * (v0 + v1))
    if lo is None:
        ph = _wrap(ph, ng)
        jh = deposit(ph, vals, ng, periodic=True, method=method)
    else:
        jh = deposit(jnp.clip(ph, lo, hi), vals, ng, periodic=False,
                     method=method)
    return (ph, v1, jh) if emit_v else (ph, jh)


def picard_finalize(field, ps, p0, v0, ng: int, *, qm, dt: float, dx: float,
                    w=None, lo=None, hi=None, impl: str = "xla",
                    method: str = "scatter", interpret: bool = False):
    """The step's final particle update from the converged field.

    Same gather and push as ``picard_pass``. Returns (p1, v1), or
    (p1, v1, j1) when ``w`` is given: j1 is the full-step current deposit
    at p1 (pypic.py:274-279). Periodic positions come back wrapped, slab
    positions raw.
    """
    _check_geometry(lo, hi, impl)
    if impl == "triton":
        return _triton_call(field, ps, p0, v0, ng, qm=qm,
                            w=0.0 if w is None else w, dt=dt, dx=dx,
                            final=True, emit_v=True, deposit_j=w is not None,
                            interpret=interpret)
    p1, v1 = _push_xla(field, ps, p0, v0, qm, dt, dx, lo, hi)
    if lo is None:
        p1 = _wrap(p1, ng)
    if w is None:
        return p1, v1
    if lo is None:
        j1 = deposit(p1, w * v1, ng, periodic=True, method=method)
    else:
        j1 = deposit(jnp.clip(p1, lo, hi), w * v1, ng, periodic=False,
                     method=method)
    return p1, v1, j1


# ---------------------------------------------------------------------------
# Triton kernel
# ---------------------------------------------------------------------------


def _kernel(s_ref, f_ref, ps_ref, p0_ref, v0_ref, acc_in, *out_refs,
            n, ng, ng_pad, final, emit_v, deposit_j, interpret):
    """One program: ``_TILES`` tiles of ``_TILE`` particles.

    Outputs, in order: positions (ph, or wrapped p1 when ``final``), then v1
    when ``emit_v``, then the (programs * ng_pad,) current rows (aliased to
    the zeroed ``acc_in``) when ``deposit_j``.
    """
    del acc_in  # aliased to the last output
    pos_ref = out_refs[0]
    v1_ref = out_refs[1] if emit_v else None
    acc_ref = out_refs[-1] if deposit_j else None
    pid = pl.program_id(0)
    a, b, dt_dx, w = s_ref[0], s_ref[1], s_ref[2], s_ref[3]
    row = pid * ng_pad

    def tile(t, carry):
        start = (pid * _TILES + t) * _TILE
        mask = start + jnp.arange(_TILE, dtype=jnp.int32) < n
        sl = pl.ds(start, _TILE)
        ps = plgpu.load(ps_ref.at[sl], mask=mask, other=0.0)
        p0 = plgpu.load(p0_ref.at[sl], mask=mask, other=0.0)
        v0 = plgpu.load(v0_ref.at[sl], mask=mask, other=0.0)
        # CIC gather (ops.cic.cic_indices_weights, periodic): node ng of the
        # padded field holds node 0, so the right node needs no wrap
        il = jnp.clip(jnp.floor(ps).astype(jnp.int32), 0, ng - 1)
        wr = ps - il.astype(ps.dtype)
        e_p = (plgpu.load(f_ref.at[il]) * (1.0 - wr)
               + plgpu.load(f_ref.at[il + 1]) * wr)
        p1 = p0 + dt_dx * v0 + b * e_p
        v1 = v0 + a * e_p
        if final:
            pos, vals = _wrap(p1, ng), w * v1
        else:
            pos, vals = _wrap(0.5 * (p0 + p1), ng), w * (0.5 * (v0 + v1))
        plgpu.store(pos_ref.at[sl], pos, mask=mask)
        if emit_v:
            plgpu.store(v1_ref.at[sl], v1, mask=mask)
        if deposit_j:
            jl = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, ng - 1)
            dr = pos - jl.astype(pos.dtype)
            vals = jnp.where(mask, vals, 0.0)
            left, right = vals * (1.0 - dr), vals * dr
            if interpret:
                # The interpreter's atomic rule keeps only one of several
                # equal indices in a vector; a scatter-add is what the
                # hardware atomics compute.
                r = pl.ds(row, ng_pad)
                acc_ref[r] = acc_ref[r].at[jl].add(left).at[jl + 1].add(right)
            else:
                plgpu.atomic_add(acc_ref, (row + jl,), left)
                plgpu.atomic_add(acc_ref, (row + jl + 1,), right)
        return carry

    lax.fori_loop(0, _TILES, tile, 0)


def _triton_call(field, ps, p0, v0, ng, *, qm, w, dt, dx, final, emit_v,
                 deposit_j, interpret):
    if jnp.ndim(w) != 0:
        raise ValueError("the Triton Picard pass takes a scalar w")
    n = ps.shape[0]
    dtype = ps.dtype
    ng_pad = pl.next_power_of_2(ng + 1)
    programs = max(1, pl.cdiv(n, _TILE * _TILES))
    f_pad = jnp.zeros((ng_pad,), dtype).at[:ng].set(field.astype(dtype))
    f_pad = f_pad.at[ng].set(field[0].astype(dtype))
    a, b, dt_dx = _coefficients(qm, dt, dx)
    scal = jnp.stack([jnp.asarray(x, dtype) for x in (a, b, dt_dx, w)])
    acc0 = jnp.zeros((programs * ng_pad if deposit_j else 1,), jnp.float32)
    out_shape = [jax.ShapeDtypeStruct((n,), dtype)]
    if emit_v:
        out_shape.append(jax.ShapeDtypeStruct((n,), v0.dtype))
    if deposit_j:
        out_shape.append(jax.ShapeDtypeStruct(acc0.shape, jnp.float32))
    kernel = functools.partial(
        _kernel, n=n, ng=ng, ng_pad=ng_pad, final=final, emit_v=emit_v,
        deposit_j=deposit_j, interpret=interpret)
    outs = pl.pallas_call(
        kernel,
        grid=(programs,),
        out_shape=tuple(out_shape),
        input_output_aliases={5: len(out_shape) - 1} if deposit_j else {},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="picard_final_triton" if final else "picard_pass_triton",
    )(scal, f_pad, ps, p0, v0, acc0)
    if not deposit_j:
        return tuple(outs[:2])
    acc = jnp.sum(outs[-1].reshape(programs, ng_pad), axis=0)
    j = acc[:ng].at[0].add(acc[ng]).astype(dtype)
    return tuple(outs[:-1]) + (j,)
