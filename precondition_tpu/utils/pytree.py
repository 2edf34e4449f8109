"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` registers the class with `jax.tree_util.register_dataclass`:
fields are leaves unless declared ``field(pytree_node=False)``, in which
case they travel in the tree structure as static metadata.  Instances are
immutable; ``x.replace(**changes)`` returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
  """A dataclass field; ``pytree_node=False`` keeps it out of the leaves."""
  return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **changes):
  return dataclasses.replace(self, **changes)


def dataclass(cls):
  """Frozen dataclass registered as a pytree, with a ``replace`` method."""
  cls = dataclasses.dataclass(frozen=True)(cls)
  fields = dataclasses.fields(cls)
  static = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
  data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
  cls.replace = _replace
  return jax.tree_util.register_dataclass(
      cls, data_fields=data, meta_fields=static)
