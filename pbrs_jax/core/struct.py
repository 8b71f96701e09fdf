"""Frozen dataclasses that are JAX pytrees.

`dataclass` registers every field as a pytree leaf unless it was declared
with `field(pytree_node=False)`, which makes it static metadata (part of
the tree structure, so jit specializes on it). Instances get
`.replace(**changes)`.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields
                     if not f.metadata.get("pytree_node", True)])
    cls.replace = dataclasses.replace
    return cls
