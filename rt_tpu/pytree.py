"""Frozen-dataclass pytrees: the base class of every device-side record.

A subclass is turned into a frozen dataclass and registered with
``jax.tree_util.register_dataclass``.  Fields declared with
:func:`static_field` are metadata: they are not leaves, they take part in
the treedef (so in a jit cache key) and must be hashable.  Every other
field is a child node (an array, another pytree, or None).
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(default=dataclasses.MISSING):
    """A field that is metadata, not a pytree leaf."""
    return dataclasses.field(default=default, metadata={"static": True})


class PyTreeNode:
    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields if not f.metadata.get("static")],
            meta_fields=[f.name for f in fields if f.metadata.get("static")],
        )

    def replace(self, **changes):
        """A copy with ``changes`` applied (dataclasses.replace)."""
        return dataclasses.replace(self, **changes)
