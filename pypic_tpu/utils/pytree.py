"""Immutable state records that are JAX pytrees.

``PyTreeNode`` turns every subclass into a frozen dataclass registered with
``jax.tree_util.register_dataclass``: each field is a pytree child, keyed by
its attribute name (so checkpoint leaf paths read ``.p``, ``.v``, ...), and
``replace`` returns a copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


class PyTreeNode:
    """Base class of the engines' state records (see module doc)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in dataclasses.fields(cls)],
            meta_fields=[],
        )

    def replace(self, **changes):
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **changes)
