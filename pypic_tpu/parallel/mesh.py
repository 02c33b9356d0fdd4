"""Device mesh helpers + multi-host bootstrap.

The reference has no communication layer at all (SURVEY.md §2.6 — zero
MPI/NCCL imports repo-wide); this is the JAX replacement: a
single-controller 1D mesh over local devices (XLA hands the collectives to
NCCL on GPUs), and an env-gated ``jax.distributed.initialize`` so the same
mesh spans hosts (multi-host runs see the *global* device list after
initialization, so ``make_mesh`` and every shard_map engine work
unchanged).
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh


def maybe_initialize_distributed() -> bool:
    """Env-gated multi-host bootstrap (SURVEY.md §5 "distributed
    communication backend"): call before any backend use on each host.

    Reads, in order of precedence:
      * ``PYPIC_COORDINATOR`` (host:port), ``PYPIC_NUM_PROCESSES``,
        ``PYPIC_PROCESS_ID`` — explicit single-purpose variables;
      * otherwise defers to ``jax.distributed.initialize()``'s own
        auto-detection (Slurm/OpenMPI env) when ``PYPIC_DISTRIBUTED=1``.

    Returns True when a distributed runtime was initialized; False when the
    environment requests none (single-host run — the common case). Safe to
    call twice (second call is a no-op).
    """
    coord = os.environ.get("PYPIC_COORDINATOR")
    auto = os.environ.get("PYPIC_DISTRIBUTED") == "1"
    if not coord and not auto:
        return False
    if jax.distributed.is_initialized():
        return True
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["PYPIC_NUM_PROCESSES"]),
            process_id=int(os.environ["PYPIC_PROCESS_ID"]),
        )
    else:
        jax.distributed.initialize()
    return True


def make_mesh(n_devices: int | None = None, axis: str = "particles") -> Mesh:
    """1D mesh over the first n_devices (default: all devices — *global*
    across hosts after ``maybe_initialize_distributed``)."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def make_mesh2(
    n_first: int, n_second: int, axes: tuple[str, str] = ("slabs", "dp")
) -> Mesh:
    """2D mesh (n_first x n_second) over the first n_first*n_second devices
    — e.g. spatial slabs x data-parallel particle replicas for the
    domain-decomposed engines (DomainImplicitConfig.dp_axis_name). The
    second axis varies fastest, so replicas of a slab sit on adjacent
    device ids; on GPUs joined all to all by NVLink every pair of devices
    is equally near, so the layout follows the algorithm alone."""
    devices = jax.devices()
    need = n_first * n_second
    if need > len(devices):
        raise ValueError(
            f"requested {need} devices, only {len(devices)} available"
        )
    return Mesh(np.asarray(devices[:need]).reshape(n_first, n_second), axes)
