"""Tearfree with Sketchy (frequent-directions) preconditioning.

Run:  python examples/tearfree_sketchy.py

The tearfree stack is the modular composition
``grafting o (merge -> second-order -> unmerge) o momentum``; Sketchy
replaces full Kronecker factors with rank-k FD sketches per tensor axis
(memory ~ rank/dim of blocked Shampoo). ``memory_alloc`` overrides the
rank per layer — produce one from real checkpoints with the
`tearfree.reallocation` CLI.
"""

import os

import jax

if os.environ.get("EXAMPLES_CPU"):  # force CPU even when a GPU is attached
  jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import optax

from precondition_tpu.tearfree import grafting
from precondition_tpu.tearfree import momentum
from precondition_tpu.tearfree import optimizer
from precondition_tpu.tearfree import second_order
from precondition_tpu.tearfree import sketchy


def main():
  options = optimizer.TearfreeOptions(
      grafting_options=grafting.Options(
          grafting_type=grafting.GraftingType.RMSPROP,
          second_moment_decay=0.999,
          start_preconditioning_step=8,
      ),
      second_order_options=second_order.Options(
          second_order_type=second_order.SecondOrderType.SKETCHY,
          shampoo_options=None,
          sketchy_options=sketchy.Options(
              rank=16,                    # FD sketch size per tensor axis
              second_moment_decay=0.999,
              # memory_alloc={"dense1": {"w": [32, 8]}},  # per-layer ranks
          ),
      ),
      momentum_options=momentum.Options(momentum_decay=0.9),
  )
  tx = optimizer.tearfree(0.003, options)

  rng = jax.random.PRNGKey(0)
  params = {
      "dense1": {"w": jax.random.normal(rng, (96, 128)) * 0.1},
      "dense2": {"w": jax.random.normal(rng, (128, 8)) * 0.1},
  }
  state = tx.init(params)

  def loss_fn(p, x, y):
    h = jnp.tanh(x @ p["dense1"]["w"])
    return jnp.mean((h @ p["dense2"]["w"] - y) ** 2)

  @jax.jit
  def step(p, st, x, y):
    loss, g = jax.value_and_grad(loss_fn)(p, x, y)
    updates, st = tx.update(g, st, p)
    return optax.apply_updates(p, updates), st, loss

  np_rng = np.random.RandomState(0)
  target = np_rng.randn(96, 8) * 0.3
  for i in range(80):
    x = np_rng.randn(64, 96).astype(np.float32)
    y = jnp.asarray(np.tanh(x) @ target, jnp.float32)
    params, state, loss = step(params, state, jnp.asarray(x), y)
    if i % 10 == 0:
      print(f"step {i:3d}  loss {float(loss):.5f}")

  # praxis-style partition specs for trainer-side checkpointing/sharding:
  specs = tx.init_partition_spec(params)
  print("state spec leaves:", len(jax.tree.leaves(
      specs, is_leaf=lambda x: hasattr(x, "shape"))))


if __name__ == "__main__":
  main()
