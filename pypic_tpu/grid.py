"""Grid geometry.

The reference carries grid geometry implicitly as loose ``(Ng, dx, L)`` scalars
(pypic.py:497-501) or inside the ``Grid`` class (pygcpic.py:780-807). Here the
*static* geometry lives in a hashable frozen dataclass that can be closed over
by ``jax.jit``; mutable field arrays are plain JAX arrays owned by each engine's
state pytree (see :mod:`pypic_tpu.engines`).

Two node/cell conventions exist in the reference and both are preserved:

* periodic (pypic.py:501): ``dx = L / ng`` — ng nodes, ng cells, node ng wraps
  to node 0.
* bounded (pygcpic.py:786-787, PIC_L_DD.py:333-334): ``dx = L / (ng - 1)`` —
  ng nodes including both walls, ng - 1 cells.

Positions are handled *in grid coordinates* ``p = x / dx`` throughout the
compute path. This is a deliberate float32-first choice: float32 then resolves
every cell to ~1e-7 of a cell width regardless of the physical domain size
(the reference's Landau preset has L ~ 5e4 m where raw float32 SI positions
would lose precision).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

PERIODIC = "periodic"
DIRICHLET_DIRICHLET = "dirichlet-dirichlet"
DIRICHLET_NEUMANN = "dirichlet-neumann"

_VALID_BCS = (PERIODIC, DIRICHLET_DIRICHLET, DIRICHLET_NEUMANN)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static 1D grid geometry (hashable; safe to close over under jit).

    Attributes:
        ng: number of field nodes.
        length: domain length [m].
        bc: one of ``periodic``, ``dirichlet-dirichlet``, ``dirichlet-neumann``.
    """

    ng: int
    length: float
    bc: str = PERIODIC

    def __post_init__(self):
        # Coerce to builtin types: numpy scalars are not weakly typed in JAX
        # and would silently promote float32 state under x64.
        object.__setattr__(self, "ng", int(self.ng))
        object.__setattr__(self, "length", float(self.length))
        if self.ng <= 1:
            raise ValueError("ng must be > 1")
        if self.length <= 0.0:
            raise ValueError("length must be > 0")
        if self.bc not in _VALID_BCS:
            raise ValueError(f"bc must be one of {_VALID_BCS}, got {self.bc!r}")

    @property
    def periodic(self) -> bool:
        return self.bc == PERIODIC

    @property
    def num_cells(self) -> int:
        """Number of CIC cells (= valid range of grid-coordinate positions)."""
        return self.ng if self.periodic else self.ng - 1

    @property
    def dx(self) -> float:
        return self.length / self.num_cells

    def nodes(self, dtype=jnp.float32) -> jnp.ndarray:
        """Physical node positions [m] (ng,)."""
        return jnp.arange(self.ng, dtype=dtype) * jnp.asarray(self.dx, dtype)

    def to_grid_coords(self, x):
        """SI position [m] -> grid coordinate p = x/dx in [0, num_cells]."""
        return x / jnp.asarray(self.dx, jnp.asarray(x).dtype)

    def to_physical(self, p):
        """Grid coordinate -> SI position [m]."""
        return p * jnp.asarray(self.dx, jnp.asarray(p).dtype)
