"""Particle and field state containers (fixed-shape pytrees).

The reference stores particles either as loose parallel numpy arrays
(pypic.py:528-547) or as a *dynamic* Python list of Particle objects that
grows by sputtering and shrinks by deletion (pygcpic.py:1624-1625,
1552-1563). Neither survives jit; the rebuild uses structure-of-arrays
pytrees with a **fixed capacity** and per-particle integer status, so every
engine step is a shape-stable jitted function:

* creation  -> claim a free slot (status INACTIVE -> ACTIVE), cf.
  ``Particle.reactivate`` (pygcpic.py:691-720);
* absorption -> flip status to LOST_LEFT/LOST_RIGHT, cf. the wall checks
  (PIC_L_DD.py:493-505, pygcpic.py:668-689);
* deletion  -> flip status to INACTIVE (the slot becomes reusable), cf. the
  compaction pass (pygcpic.py:1552-1563).

Status codes intentionally embed the reference's ``active`` convention for
the sheath engine (PIC_L_DD.py:41-68: 1 = active, 0 = absorbed at the right
wall, -1 = absorbed at the left wall) so wall-charge deposits read exactly
like the reference.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

# Status codes. ACTIVE/LOST_RIGHT/LOST_LEFT match PIC_L_DD.py's active flags.
ACTIVE = 1
LOST_RIGHT = 0
LOST_LEFT = -1
INACTIVE = -2  # free slot (never been active / deleted)


class Particles1V(PyTreeNode):
    """Lean single-species 1d1v particles for the periodic engines.

    Mirrors the array set of the gen-3 implicit engine (pypic.py:528-547):
    all particles share one (q, m, p2c); positions are grid coordinates.
    """

    p: jax.Array  # (n,) position / dx
    v: jax.Array  # (n,) velocity [m/s]

    @property
    def n(self) -> int:
        return self.p.shape[0]


class Particles(PyTreeNode):
    """General multi-species 1d3v particles (sheath / magnetized engines).

    Field-per-field parity with the reference's per-particle attributes:
    ``r=[x,y,z,vx,vy,vz,t]`` + m/charge_state/Z/p2c + lifecycle flags
    (pygcpic.py:94-111) and the two-species arrays of PIC_L_DD.py:231-241.
    """

    p: jax.Array  # (n,) x position in grid coordinates
    yz: jax.Array  # (n, 2) lateral positions [m] (diagnostics only; fields are 1D)
    v: jax.Array  # (n, 3) velocity [m/s]
    m: jax.Array  # (n,) mass [kg]
    charge_state: jax.Array  # (n,) charge number; q = charge_state * e
    p2c: jax.Array  # (n,) physical particles per computational particle
    species: jax.Array  # (n,) int32 species tag (atomic number Z for pygcpic)
    t: jax.Array  # (n,) particle proper time [s]
    status: jax.Array  # (n,) int32 status code (see module constants)
    at_wall: jax.Array  # (n,) int32 — deactivated by hitting a wall
    from_wall: jax.Array  # (n,) int32 — created at a wall (BCA products)

    @property
    def n(self) -> int:
        return self.p.shape[0]

    @property
    def active(self) -> jax.Array:
        return self.status == ACTIVE

    def charge(self) -> jax.Array:
        from .constants import E_CHARGE

        return self.charge_state * E_CHARGE


def make_particles(
    n: int,
    *,
    p=0.0,
    yz=0.0,
    v=0.0,
    m=0.0,
    charge_state=0.0,
    p2c=0.0,
    species=0,
    t=0.0,
    status=INACTIVE,
    at_wall=0,
    from_wall=0,
    dtype=jnp.float32,
) -> Particles:
    """Build a Particles pytree from scalars or (n,)-broadcastable arrays."""

    def full(val, shape, dt):
        arr = jnp.asarray(val, dt)
        return jnp.broadcast_to(arr, shape).astype(dt)

    return Particles(
        p=full(p, (n,), dtype),
        yz=full(yz, (n, 2), dtype),
        v=full(v, (n, 3), dtype),
        m=full(m, (n,), dtype),
        charge_state=full(charge_state, (n,), dtype),
        p2c=full(p2c, (n,), dtype),
        species=full(species, (n,), jnp.int32),
        t=full(t, (n,), dtype),
        status=full(status, (n,), jnp.int32),
        at_wall=full(at_wall, (n,), jnp.int32),
        from_wall=full(from_wall, (n,), jnp.int32),
    )
