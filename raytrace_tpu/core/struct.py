"""Frozen dataclasses registered as JAX pytrees.

`dataclass` makes a class a frozen dataclass whose fields are pytree
children, except fields declared with `field(pytree_node=False)`: those are
static metadata (part of the treedef, so jit specializes on them). Every
instance gets `.replace(**changes)`, a `dataclasses.replace` shorthand.
"""
from __future__ import annotations

import dataclasses

import jax

_PYTREE_NODE = "pytree_node"


def field(pytree_node: bool = True, **kwargs):
    """dataclasses.field with a pytree_node flag (False = static field)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata[_PYTREE_NODE] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + pytree registration (static fields as metadata)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get(_PYTREE_NODE, True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
