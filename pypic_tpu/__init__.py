"""pypic_tpu — a JAX 1D electrostatic particle-in-cell framework.

A from-scratch JAX/XLA rebuild with the capabilities of the reference CPU code
drobnyjt/pyPIC (four generations of a 1D electrostatic PIC engine; see
SURVEY.md at the repo root for the full layer map). The per-timestep cycle
(deposit -> field solve -> gather -> push -> boundary conditions) is a single
jitted fixed-shape step function per engine family; deposits are matmul/
segment reductions instead of sequential scatters; iterative solvers are
``lax.while_loop``; time integration is ``lax.scan``; multi-chip scaling uses
``shard_map`` over a ``jax.sharding.Mesh`` (see pypic_tpu.parallel).
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401
from .grid import GridSpec, PERIODIC, DIRICHLET_DIRICHLET, DIRICHLET_NEUMANN  # noqa: F401
