"""Data-parallel particles over a device mesh (shard_map).

The natural first decomposition for 1D PIC: particle arrays shard over the
mesh axis; the grid (Ng = 40-800 everywhere in the reference, pypic.py:851,
pygcpic.py:1973) is replicated. Per shard, gather/push are purely local;
deposits produce partial grids that one ``psum`` across the devices reduces, after
which the (replicated) field solve and Picard/Newton control flow proceed
bitwise identically on every device — so the while_loop trip counts agree
across shards by construction.

This is the JAX equivalent of the communication layer the reference
never had (SURVEY.md §2.6): the engines already emit ``lax.psum`` on their
deposits when ``cfg.axis_name`` is set; this module wraps the step in
``shard_map`` with the matching partitioning.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map


# Per-particle field names across the engine state classes. Name-based (not
# shape-based) so a grid field with ng == n can never be mis-sharded.
_PARTICLE_FIELDS = frozenset({
    "p", "v", "q", "m", "yz", "charge_state", "p2c", "species", "species_idx",
    "t", "status", "active", "at_wall", "from_wall", "alive", "mode",
    # round-3 flat component leaves (SheathState / MagnetizedState)
    "u", "vx", "vy", "vz", "y", "z",
})


def _state_specs(state, axis: str):
    """PartitionSpec pytree: named per-particle arrays sharded, everything
    else (fields, scalars, counters) replicated."""
    n = state.p.shape[0]
    specs = {}
    for name in state.__dataclass_fields__:
        leaf = getattr(state, name)
        shard = (
            name in _PARTICLE_FIELDS
            and hasattr(leaf, "ndim")
            and leaf.ndim >= 1
            and leaf.shape[0] == n
        )
        specs[name] = P(axis) if shard else P()
    return type(state)(**specs)


def shard_state(state, mesh: Mesh, axis: str = "particles"):
    """Device-put a state pytree with particle arrays sharded over the mesh."""
    specs = _state_specs(state, axis)
    return jax.tree.map(
        lambda leaf, s: jax.device_put(leaf, jax.sharding.NamedSharding(mesh, s)),
        state,
        specs,
    )


def make_data_parallel_step(
    make_step: Callable, cfg, mesh: Mesh, axis: str = "particles",
    metrics_cls=None, example_state=None,
):
    """Wrap an engine's step in shard_map over ``mesh``.

    Args:
        make_step: the engine's make_step (e.g. engines.implicit.make_step).
        cfg: engine config; must carry ``axis_name=axis`` so the engine emits
            the psum reductions.
        mesh: 1D device mesh.
        axis: mesh axis name (must equal cfg.axis_name).
        example_state: a state pytree used to derive in/out partition specs.

    Returns:
        step(state) -> (state, metrics), shard_mapped; feed it states placed
        with ``shard_state``.
    """
    if getattr(cfg, "axis_name", None) != axis:
        raise ValueError(
            f"cfg.axis_name={getattr(cfg, 'axis_name', None)!r} must equal {axis!r}"
        )
    if example_state is None:
        raise ValueError("example_state is required to derive partition specs")

    inner = make_step(cfg)
    state_specs = _state_specs(example_state, axis)
    # Metrics are replicated (every scalar is psum'd or grid-derived inside);
    # P() as a pytree prefix covers the whole metrics tuple.
    # jit the shard_mapped step: an UN-jitted shard_map dispatches
    # eagerly op-by-op per shard (~1000x slower on the virtual CPU mesh);
    # callers that wrap it again in jax.jit / lax.scan are unaffected
    # (nested jit is free).
    return jax.jit(shard_map(
        inner,
        mesh=mesh,
        in_specs=(state_specs,),
        out_specs=(state_specs, P()),
        check_vma=False,
    ))
