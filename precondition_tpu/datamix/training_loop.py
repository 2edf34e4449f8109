"""Finetuning loop for the bandit's inner training runs.

Equivalent of the reference's `TrainingLoop`
(`/root/reference/precondition/datamix_gemma/training_loop.py`): a fixed
number of steps over generator-produced batches with per-example loss
``factors``, plus a validation step.  Differences: one jit'd
SPMD step over a Mesh (no pmap, no host-side per-device batch slicing —
GSPMD shards the batch), and the background prefetch thread feeds
device_put'ed batches through a depth-1 queue so host tokenisation
overlaps device compute.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from precondition_tpu.models import transformer

Array = jax.Array


class BackgroundGenerator:
  """Prefetch thread with a bounded queue (depth 1, like the reference)."""

  def __init__(self, generator, max_prefetch: int = 1):
    self.queue: queue.Queue = queue.Queue(max_prefetch)
    self.generator = generator
    self.thread = threading.Thread(target=self._run, daemon=True)
    self.thread.start()

  def _run(self):
    try:
      for item in self.generator:
        self.queue.put(item)
    finally:
      self.queue.put(None)

  def __iter__(self):
    return self

  def __next__(self):
    item = self.queue.get()
    if item is None:
      raise StopIteration
    return item


@dataclasses.dataclass
class TrainingLoop:
  """Runs ``num_training_steps`` optimizer steps from a batch-generator fn."""

  cfg: transformer.TransformerConfig
  optimizer: optax.GradientTransformation
  num_training_steps: int = 8
  mesh: Optional[Any] = None

  def __post_init__(self):

    def step(params, opt_state, batch):
      def loss_fn(p):
        return transformer.loss_fn(p, batch, self.cfg)

      loss, grads = jax.value_and_grad(loss_fn)(params)
      updates, opt_state = self.optimizer.update(grads, opt_state, params)
      params = jax.tree.map(lambda a, u: a + u, params, updates)
      return loss, params, opt_state

    self._train_step = jax.jit(step, donate_argnums=(0, 1))

    def val_step(params, batch):
      return transformer.loss_fn(params, batch, self.cfg)

    self._val_step = jax.jit(val_step)

  def _device_batch(self, factors, tokens, masks):
    batch = {
        "tokens": jnp.asarray(tokens),
        "target_mask": jnp.asarray(masks),
        "factors": jnp.asarray(factors),
    }
    if self.mesh is not None:
      from jax.sharding import NamedSharding, PartitionSpec as P

      sharding = NamedSharding(self.mesh, P("data"))
      batch = jax.tree.map(
          lambda x: jax.device_put(x, sharding), batch)
    return batch

  def train_loop(self, params, get_next_batch_fn: Callable[[], Any]):
    """Train for the configured number of steps; returns trained params."""
    if isinstance(params, dict) and set(params) == {"params"}:
      inner = params["params"]
      wrapped = True
    else:
      inner, wrapped = params, False

    opt_state = self.optimizer.init(inner)

    def batches():
      for _ in range(self.num_training_steps):
        yield self._device_batch(*get_next_batch_fn())

    for batch in BackgroundGenerator(batches()):
      loss, inner, opt_state = self._train_step(inner, opt_state, batch)
    jax.block_until_ready(inner)
    return {"params": inner} if wrapped else inner

  def validation_loss(self, params, batches) -> float:
    """Mean masked loss over an iterable of (factors, tokens, masks)."""
    losses = [
        float(self._val_step(params, self._device_batch(*b))) for b in batches
    ]
    return float(np.mean(losses)) if losses else float("nan")
