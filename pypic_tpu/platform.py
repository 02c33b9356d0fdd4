"""The one place that picks an implementation for the device at hand.

Three choices depend on the accelerator and on problem size, and every engine
asks this module instead of testing the backend itself:

* ``picard_impl`` — the fused Picard pass of the implicit engines
  (``ops.picard``): ``'xla'`` (plain ``jnp``, compiled by XLA) or
  ``'triton'`` (a Pallas kernel through Triton, NVIDIA GPUs only);
* ``deposit_method`` — the CIC deposit (``ops.cic.deposit``): ``'scatter'``
  (XLA scatter-add) or ``'matmul'`` (tent-matrix product);
* ``tridiag_method`` — the tridiagonal solve (``ops.tridiag``):
  ``'thomas'`` (sequential scan) or ``'pscan'`` (associative scan).

Each default is the measured winner on the device it names; a platform this
module does not know gets the plain XLA choice. ``compile_cache`` places
JAX's persistent compilation cache for the command-line entry points.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

import jax

PICARD_IMPLS = ("xla", "triton")
DEPOSIT_METHODS = ("scatter", "matmul")
TRIDIAG_METHODS = ("thomas", "pscan")

# <repo>/.jax_cache: a fixed path, so a later process finds what an earlier
# one compiled (the directory is part of the cache key).
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def device_platform() -> str:
    """Platform of the first device, as JAX names it ('cpu', 'gpu', ...)."""
    return jax.devices()[0].platform


def picard_impl(n: int, requested: str = "auto",
                platform: str | None = None) -> str:
    """Implementation of the implicit engines' Picard pass for n particles.

    'triton' is a Pallas kernel compiled through Triton and exists only on
    NVIDIA GPUs; asking for it anywhere else raises ValueError. 'auto' is
    'triton' on a GPU, where it ran the 1e8-particle, ng=200 pass in 3.4 ms
    against 62.7 ms for the XLA pass on an H100 (PERF.md, H100 section),
    and 'xla' on every other platform.
    """
    platform = platform or device_platform()
    if requested == "auto":
        return "triton" if platform == "gpu" else "xla"
    if requested not in PICARD_IMPLS:
        raise ValueError(f"unknown Picard implementation {requested!r}")
    if requested == "triton" and platform != "gpu":
        raise ValueError(
            f"picard impl 'triton' needs an NVIDIA GPU, found {platform!r}")
    del n  # one choice at every size measured so far
    return requested


def deposit_method(n: int, ng: int, platform: str | None = None) -> str:
    """Default CIC deposit. 'scatter' on every platform until the card has
    timed 'matmul' against it inside the engines."""
    del n, ng, platform
    return "scatter"


def tridiag_method(n: int, platform: str | None = None) -> str:
    """Default tridiagonal solver. 'thomas' on every platform until the card
    has timed 'pscan' against it inside the Newton loop."""
    del n, platform
    return "thomas"


def compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself). Otherwise the cache lives at ``<repo>/.jax_cache``. Call it
    before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    path = env or str(DEFAULT_CACHE_DIR)
    if not env:
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every executable, however quick its compile
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def gpu_name_and_power_limit() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first GPU, e.g.
    ``'NVIDIA H100 80GB HBM3, 400.00 W'``, or None where there is no NVIDIA
    GPU. Asks nvidia-smi, not JAX, so a parent process can call it without
    claiming the card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (subprocess.SubprocessError, OSError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if lines else None
