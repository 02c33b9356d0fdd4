"""Particle source distributions (vectorized RNG samplers).

Rebuilds the reference's infinite Python generators as batch samplers:

* ``sample_source_6d``: volumetric Maxwellian source, gaussian-in-x centered
  mid-domain with sigma L/12, wrapped periodically (pygcpic.py:723-755
  ``source_distribution_6D``). NB the reference adds the drift ``vx`` to all
  three velocity components (pygcpic.py:752) — preserved.
* ``sample_flux_6d``: wall-flux source at the right wall: x in the last cell,
  v_x drawn from the flux-weighted speed distribution |v| g(v; vx, vth) via
  a 100-point discretization + uniform jitter of half a bin, made incoming
  (negative), plus an optional probability-gamma perturbed beam at
  ``vx_pert * vth`` (pygcpic.py:760-778 ``flux_distribution_6D``).

Returned batches are dicts of SI arrays {x, yz, v}; engines mask in however
many they actually consume (re-activation caps, pygcpic.py:2055-2060).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .constants import K_BOLTZMANN
from .grid import GridSpec


def sample_source_6d(key, n: int, grid: GridSpec, ti: float, mass: float,
                     vx: float = 0.0, dtype=jnp.float32,
                     components: bool = False):
    """Volumetric Maxwellian source batch (pygcpic.py:723-755).

    ``components=True`` returns flat {"x", "vx", "vy", "vz"} rows drawn as
    a (3, n) normal (contiguous rows — no (n, 3) slice materialization in the
    consumer; different draws than the stacked form, same distribution)."""
    kx, kv = jax.random.split(key)
    length = grid.length
    vth = float(np.sqrt(K_BOLTZMANN * float(ti) / float(mass)))
    x = jax.random.normal(kx, (n,), dtype) * (length / 12.0) + length / 2.0
    x = jnp.mod(x, length)
    if components:
        z = jax.random.normal(kv, (3, n), dtype) * vth + vx
        return {"x": x, "vx": z[0], "vy": z[1], "vz": z[2]}
    v = jax.random.normal(kv, (n, 3), dtype) * vth + vx
    return {"x": x, "yz": jnp.zeros((n, 2), dtype), "v": v}


# --- counter-based fast sampler -------------------------------------------
#
# Re-activation policies resample a full-capacity batch every step and mask
# in the handful of slots that actually need it (fixed shapes under jit).
# A counter-based generator (the curand/Philox idea) makes such batches
# shard-count-invariant and cheap: hash (slot index, step seed) with a
# strong 32-bit mixer and turn the uniforms into exact gaussians via
# Box-Muller. ~30 fused elementwise ops per slot, no tables,
# bit-deterministic given the step key, identical distribution.


def _mix32(x):
    """murmur3 finalizer (public domain): full-avalanche 32-bit mixer."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


_GOLDEN = 0x9E3779B9  # 2^32 / phi: decorrelates stream offsets


def hash_uniforms(seed, n: int, streams: int, dtype=jnp.float32, offset=0):
    """(streams, n) uniforms in (0, 1), open at both ends (Box-Muller safe).

    seed: uint32 scalar (vary per step); each stream is an independent
    full-period counter sequence. ``offset`` shifts the counter (slot)
    ids — under data-parallel sharding, shard r passing
    offset = r * local_n makes the sharded draw bit-identical to the
    single-device draw over the concatenated slots (shard-count-invariant
    randomness, something a split-key stream cannot give).
    """
    idx = lax.iota(jnp.uint32, n) + jnp.uint32(offset)
    offs = (jnp.arange(1, streams + 1, dtype=jnp.uint32)
            * jnp.uint32(_GOLDEN))[:, None]
    h = _mix32(_mix32(idx[None, :] + offs) ^ jnp.uint32(seed))
    # 24-bit mantissa path: u in [2^-25, 1 - 2^-25]
    return ((h >> 8).astype(dtype) + 0.5) * dtype(2.0**-24)


def hash_normals(seed, n: int, pairs: int, dtype=jnp.float32, offset=0):
    """(2*pairs, n) standard normals via Box-Muller on hash_uniforms."""
    u = hash_uniforms(seed, n, 2 * pairs, dtype, offset=offset)
    r = jnp.sqrt(-2.0 * jnp.log(u[0::2]))
    theta = dtype(2.0 * np.pi) * u[1::2]
    return jnp.concatenate([r * jnp.cos(theta), r * jnp.sin(theta)], axis=0)


def seed_from_key(key):
    """uint32 scalar seed from a jax PRNG key (deterministic per step)."""
    data = jax.random.key_data(key).reshape(-1)
    return (data[0] ^ data[-1]).astype(jnp.uint32)


def sample_source_6d_hash(key, n: int, grid: GridSpec, ti: float,
                          mass: float, vx: float = 0.0, dtype=jnp.float32,
                          slot_offset=0, components: bool = False):
    """``sample_source_6d`` on the counter-based generator: identical
    distribution (gaussian-in-x at L/2 sigma L/12 wrapped, Maxwellian
    3-velocity + vx on every component, pygcpic.py:723-755), without
    threefry's erfinv. ``slot_offset``: see hash_uniforms — shard-count-
    invariant batches under data-parallel sharding."""
    length = grid.length
    vth = float(np.sqrt(K_BOLTZMANN * float(ti) / float(mass)))
    z = hash_normals(seed_from_key(key), n, 2, dtype, offset=slot_offset)
    x = jnp.mod(z[0] * dtype(length / 12.0) + dtype(length / 2.0),
                dtype(length))
    if components:
        return {"x": x, "vx": z[1] * dtype(vth) + dtype(vx),
                "vy": z[2] * dtype(vth) + dtype(vx),
                "vz": z[3] * dtype(vth) + dtype(vx)}
    v = z[1:4].T * dtype(vth) + dtype(vx)
    return {"x": x, "yz": jnp.zeros((n, 2), dtype), "v": v}


def sample_flux_6d(key, n: int, grid: GridSpec, ti: float, mass: float,
                   vx: float = 0.0, gamma: float = 0.0, vx_pert: float = 0.0,
                   num_vels: int = 100, dtype=jnp.float32,
                   components: bool = False):
    """Wall-flux source batch at the right wall (pygcpic.py:760-778).
    ``components=True``: see sample_source_6d."""
    kx, kv, kc, kj, kg = jax.random.split(key, 5)
    length = grid.length
    dx = grid.dx
    vth = float(np.sqrt(K_BOLTZMANN * float(ti) / float(mass)))

    x = length - dx * jax.random.uniform(kx, (n,), dtype)
    zc = jax.random.normal(kv, (2, n), dtype) * vth if components else None
    v = None if components else jax.random.normal(kv, (n, 3), dtype) * vth

    # flux-weighted speed distribution on a [-6 vth, 6 vth] grid
    vels = jnp.linspace(-6.0 * vth, 6.0 * vth, num_vels, dtype=dtype)
    dvel = vels[1] - vels[0]
    weights = jnp.exp(-((vels - vx) ** 2) / (2.0 * vth * vth)) * jnp.abs(vels)
    logits = jnp.log(weights + 1e-30)
    idx = jax.random.categorical(kc, logits, shape=(n,))
    jitter = jax.random.uniform(kj, (n,), dtype, -1.0, 1.0) * (dvel / 2.0)
    # jitter applied after the -|.| and before the drift, as the reference
    # does (pygcpic.py:772-773)
    v_x = -jnp.abs(vels[idx]) + jitter + vx
    pert = jax.random.uniform(kg, (n,), dtype) < gamma
    v_x = jnp.where(pert, vx_pert * vth, v_x)
    if components:
        return {"x": x, "vx": v_x.astype(dtype), "vy": zc[0], "vz": zc[1]}
    v = v.at[:, 0].set(v_x)
    return {"x": x, "yz": jnp.zeros((n, 2), dtype), "v": v}


def sample_flux_6d_hash(key, n: int, grid: GridSpec, ti: float, mass: float,
                        vx: float = 0.0, gamma: float = 0.0,
                        vx_pert: float = 0.0, num_vels: int = 100,
                        dtype=jnp.float32, slot_offset=0,
                        components: bool = False):
    """``sample_flux_6d`` on the counter-based generator: identical
    distribution — the categorical table draw becomes an inverse-CDF lookup
    on a per-slot uniform (same pmf), Maxwellian 3-velocity via Box-Muller,
    jitter/perturbation gates from per-slot uniforms. ``slot_offset``: see
    ``hash_uniforms`` — shard r passing r * local_n makes the sharded batch
    bit-identical to the single-device batch over the concatenated slots,
    which a replicated threefry categorical draw cannot provide (the 'flux'
    re-activation cap under data-parallel sharding needs it)."""
    length = grid.length
    dx = grid.dx
    vth = float(np.sqrt(K_BOLTZMANN * float(ti) / float(mass)))
    u = hash_uniforms(seed_from_key(key), n, 8, dtype, offset=slot_offset)

    x = dtype(length) - dtype(dx) * u[0]
    # 3 standard normals from 2 Box-Muller pairs (4th output unused)
    r1 = jnp.sqrt(-2.0 * jnp.log(u[1]))
    r2 = jnp.sqrt(-2.0 * jnp.log(u[2]))
    th1 = dtype(2.0 * np.pi) * u[3]
    th2 = dtype(2.0 * np.pi) * u[4]
    zy = r1 * jnp.sin(th1) * dtype(vth)
    zz = r2 * jnp.cos(th2) * dtype(vth)
    v = None if components else jnp.stack(
        [r1 * jnp.cos(th1), r1 * jnp.sin(th1), r2 * jnp.cos(th2)], axis=-1
    ) * dtype(vth)

    # flux-weighted speed pmf on the same [-6 vth, 6 vth] grid as the
    # threefry sampler (pygcpic.py:760-778); inverse-CDF draw
    vels = jnp.linspace(-6.0 * vth, 6.0 * vth, num_vels, dtype=dtype)
    dvel = vels[1] - vels[0]
    weights = jnp.exp(-((vels - vx) ** 2) / (2.0 * vth * vth)) * jnp.abs(vels)
    cdf = jnp.cumsum(weights) / jnp.sum(weights)
    idx = jnp.searchsorted(cdf, u[5])
    jitter = (2.0 * u[6] - 1.0) * (dvel / 2.0)
    v_x = -jnp.abs(vels[idx]) + jitter + vx
    pert = u[7] < gamma
    v_x = jnp.where(pert, dtype(vx_pert * vth), v_x)
    if components:
        return {"x": x, "vx": v_x.astype(dtype), "vy": zy, "vz": zz}
    v = v.at[:, 0].set(v_x.astype(dtype))
    return {"x": x, "yz": jnp.zeros((n, 2), dtype), "v": v}


def gaussian_distribution(x, mu, sigma):
    """Normal pdf (pygcpic.py:31-32)."""
    return (
        1.0 / jnp.sqrt(2.0 * jnp.pi * sigma**2)
        * jnp.exp(-((x - mu) ** 2) / (2.0 * sigma**2))
    )


def weighted_gaussian(x, mu, sigma):
    """Flux-weighted normal pdf |x| g(x) (pygcpic.py:757-758)."""
    return gaussian_distribution(x, mu, sigma) * jnp.abs(x)


def sample_to_fill_distribution(key, ideal_distribution, dist_args, lo, hi,
                                num_bins, population, sample_size=1):
    """Deficit-weighted refill sampling (pygcpic.py:19-29): histogram the
    population, sample new values proportional to the positive part of
    (ideal pdf - empirical pdf), with uniform jitter of one bin width.

    Vectorized port of the reference's numpy version; returns
    (sample_size,) draws.
    """
    kc, kj = jax.random.split(key)
    edges = jnp.linspace(lo, hi, num_bins)
    heights, _ = jnp.histogram(jnp.asarray(population), bins=edges,
                               density=True)
    centers = edges[:-1] + (edges[1] - edges[0]) / 2.0
    ideal = ideal_distribution(centers, *dist_args)
    difference = jnp.clip(ideal - heights, 0.0, None)
    logits = jnp.log(difference + 1e-30)
    idx = jax.random.categorical(kc, logits, shape=(sample_size,))
    jitter = jax.random.uniform(kj, (sample_size,), minval=-1.0, maxval=1.0)
    return centers[idx] + jitter * (centers[1] - centers[0])
