"""Multi-chip scaling: device meshes, data-parallel particles, domain
decomposition.

The reference is entirely single-process (SURVEY.md §2.6 — no MPI/NCCL/
threading beyond numba flags); this package is the new capability layer:
JAX collectives (NCCL on GPUs) replace the nonexistent comm backend.
"""

from .dataparallel import make_data_parallel_step, shard_state  # noqa: F401
from .mesh import make_mesh, make_mesh2  # noqa: F401
from . import domain, domain_implicit, domain_magnetized, domain_sheath  # noqa: F401
