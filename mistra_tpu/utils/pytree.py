"""Frozen dataclasses that are JAX pytrees.

``@pytree_dataclass`` makes a frozen dataclass whose fields are all pytree
children, registered with ``jax.tree_util.register_dataclass``, and gives it
``.replace(**changes)`` for functional updates of the model state.
"""

from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    """Class decorator: frozen dataclass + pytree node + ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names,
                                            meta_fields=[])
