"""Mesh construction and sharding rules.

The reference's distribution story is pmap + hand-rolled round-robin
(upstream `precondition/distributed_shampoo.py:2816-3010`); here it
is a `jax.sharding.Mesh` with named axes and `NamedSharding` annotations,
letting XLA insert the collectives.

Axis conventions used throughout the framework:
  * ``data``  — data parallelism (batch axis, gradient all-reduce).
  * ``model`` — tensor parallelism (matmul sharding inside layers).
The stacked ``[N, m, m]`` preconditioner solves shard over ``data`` x
``model`` flattened (every chip solves a slice; results all-gather).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    devices=None,
) -> Mesh:
  """Build a mesh over the available devices.

  Defaults to all devices on the ``data`` axis (``model=1``) when no shape
  is given.  Shapes are validated against the device count.
  """
  devices = list(devices if devices is not None else jax.devices())
  n = len(devices)
  if shape is None:
    shape = (n,) + (1,) * (len(axis_names) - 1)
  if int(np.prod(shape)) != n:
    raise ValueError(f"Mesh shape {shape} does not cover {n} devices")
  dev_array = np.asarray(devices).reshape(shape)
  return Mesh(dev_array, tuple(axis_names))


def sharding(mesh: Mesh, *spec) -> NamedSharding:
  return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
  return NamedSharding(mesh, P())


def shard_params(params, mesh: Mesh, rules):
  """Apply ``rules`` (path-regex -> PartitionSpec) to a param tree.

  Rules are matched against '/'-joined tree paths; the first match wins and
  unmatched params are replicated.
  """
  import re

  flat, treedef = jax.tree_util.tree_flatten_with_path(params)
  out = []
  for path, leaf in flat:
    name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)
    spec = P()
    for pattern, s in rules:
      if re.search(pattern, name):
        spec = s
        break
    out.append(jax.device_put(leaf, NamedSharding(mesh, spec)))
  return jax.tree_util.tree_unflatten(treedef, out)
