"""Frozen pytree dataclasses: the scene, hit and sample records.

``@dataclass`` makes a frozen ``dataclasses.dataclass`` and registers it
with ``jax.tree_util.register_dataclass``.  Fields declared with
``field(pytree_node=False)`` are meta fields: they live in the treedef, so
``jit`` specialises on their values (counts, enum codes, resolutions), while
every other field is a leaf that ``jit`` traces and ``grad`` differentiates.
``.replace(**updates)`` returns a copy with the given fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node=True, **kwargs):
    """``dataclasses.field`` that records whether the field is a leaf."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree (see module docstring)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)

    def replace(self, **updates):
        """Returns a copy with the given fields replaced."""
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    return cls
