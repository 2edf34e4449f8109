"""SPMD training loop: jit + Mesh, no pmap.

The reference's loop is pmap + host-side batch slicing
(upstream `precondition/datamix_gemma/training_loop.py:213-327`); this
version is a single jit'd step over a Mesh with NamedSharding on
params/batch — XLA inserts the gradient all-reduce, multihost falls out of
GSPMD for free, and the optimizer's stacked root solves shard over the same
mesh.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from precondition_tpu.parallel import mesh as mesh_lib


def make_train_step(loss_fn: Callable, tx) -> Callable:
  """Pure (params, opt_state, batch) -> (loss, params, opt_state)."""

  def step(params, opt_state, batch):
    loss, grads = jax.value_and_grad(loss_fn)(params, batch)
    updates, opt_state = tx.update(grads, opt_state, params)
    params = jax.tree.map(lambda p, u: p + u, params, updates)
    return loss, params, opt_state

  return step


def make_sharded_train_step(
    loss_fn: Callable,
    tx,
    mesh: Mesh,
    param_rules=(),
    batch_spec: P = P("data"),
) -> Callable:
  """jit the train step with sharding constraints over ``mesh``.

  Params follow ``param_rules`` (regex -> PartitionSpec, see
  `parallel.mesh.shard_params`); the batch shards its leading axis on
  ``data``.  Params and optimizer state come back with the layout they
  were passed in with, so each step takes what the last one returned
  without a reshard or a recompile.  A leaf that is not committed to
  devices (e.g. eager ``tx.init`` zeros) is replicated over ``mesh``;
  place the state yourself for another layout.  The step has ``.lower``
  like a jitted function.
  """
  del param_rules  # The params carry their layout (`shard_params`).
  step = make_train_step(loss_fn, tx)
  batch_sharding = NamedSharding(mesh, batch_spec)
  replicated = NamedSharding(mesh, P())

  def constrained(params, opt_state, batch):
    batch = jax.lax.with_sharding_constraint(
        batch, jax.tree.map(lambda _: batch_sharding, batch))
    return step(params, opt_state, batch)

  jitted = {}

  def for_state(params, opt_state):
    layout = jax.tree.map(
        lambda x: x.sharding if getattr(x, "committed", False)
        else replicated, (params, opt_state))
    leaves, treedef = jax.tree.flatten(layout)
    key = (treedef, tuple(leaves))
    if key not in jitted:
      jitted[key] = jax.jit(
          constrained, donate_argnums=(0, 1),
          in_shardings=layout + (None,),
          out_shardings=(replicated,) + layout)
    return jitted[key]

  def sharded_step(params, opt_state, batch):
    # Commit uncommitted leaves first, or the next call (which gets them
    # back committed) would miss jit's cache and compile again.
    params, opt_state = jax.tree.map(
        lambda x: x if getattr(x, "committed", False)
        else jax.device_put(x, replicated), (params, opt_state))
    return for_state(params, opt_state)(params, opt_state, batch)

  sharded_step.lower = lambda params, opt_state, batch: for_state(
      params, opt_state).lower(params, opt_state, batch)
  return sharded_step


def train(
    loss_fn: Callable,
    tx,
    params,
    batches,
    mesh: Optional[Mesh] = None,
    param_rules=(),
    log_every: int = 0,
    log_fn=print,
) -> Tuple[Any, Any, list]:
  """Simple driver: init optimizer state, run all batches, return history."""
  opt_state = tx.init(params)
  if mesh is not None:
    params = mesh_lib.shard_params(params, mesh, param_rules)
    step = make_sharded_train_step(loss_fn, tx, mesh, param_rules)
  else:
    step = jax.jit(make_train_step(loss_fn, tx))
  losses = []
  for i, batch in enumerate(batches):
    loss, params, opt_state = step(params, opt_state, batch)
    losses.append(loss)
    if log_every and (i % log_every == 0):
      log_fn(f"step {i}: loss {float(loss):.4f}")
  return params, opt_state, losses
