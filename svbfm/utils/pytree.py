"""Frozen dataclasses that are JAX pytrees.

Every learner state and device-data bundle is a frozen dataclass whose
fields are all pytree children, so it passes through ``jit``, ``shard_map``
and ``jax.tree.map`` and is updated functionally with ``.replace``.  Leaves
flatten with attribute key paths (``.mu_w``, ``.blocks``), which name the
arrays in checkpoints (``utils/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    """Make ``cls`` a frozen dataclass registered as a pytree node whose
    fields are all children, with a ``replace(**changes)`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])
    cls.replace = _replace
    return cls
