"""Quickstart: distributed Shampoo on a small MLP, single device.

Run:  python examples/quickstart.py        (GPU if available, else CPU)

Shows the optax-compatible surface: build the transformation, init state
from params, jit the update. Configs written for
google-research/precondition's `distributed_shampoo` port unchanged
(see MIGRATION.md).
"""

import os

import jax

if os.environ.get("EXAMPLES_CPU"):  # force CPU even when a GPU is attached
  jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import optax

import precondition_tpu


def init_mlp(rng, sizes=(64, 256, 256, 10)):
  params = []
  for i, (m, n) in enumerate(zip(sizes[:-1], sizes[1:])):
    k = jax.random.fold_in(rng, i)
    params.append({
        "w": jax.random.normal(k, (m, n)) * (1.0 / np.sqrt(m)),
        "b": jnp.zeros((n,)),
    })
  return params


def forward(params, x):
  for layer in params[:-1]:
    x = jax.nn.relu(x @ layer["w"] + layer["b"])
  return x @ params[-1]["w"] + params[-1]["b"]


def loss_fn(params, batch):
  logits = forward(params, batch["x"])
  return optax.softmax_cross_entropy_with_integer_labels(
      logits, batch["y"]).mean()


def main():
  tx = precondition_tpu.distributed_shampoo(
      learning_rate=0.003,
      block_size=128,
      graft_type=precondition_tpu.GraftingType.RMSPROP,
      start_preconditioning_step=10,
      preconditioning_compute_steps=2,  # solve roots every other step
      generate_training_metrics=True,   # root errors/iters ride in state
  )

  params = init_mlp(jax.random.PRNGKey(0))
  state = tx.init(params)

  @jax.jit
  def step(params, state, batch):
    loss, grads = jax.value_and_grad(loss_fn)(params, batch)
    updates, state = tx.update(grads, state, params)
    return optax.apply_updates(params, updates), state, loss

  rng = np.random.RandomState(0)
  x = rng.randn(256, 64).astype(np.float32)
  y = (x[:, 0] > 0).astype(np.int32) * 5 + (x[:, 1] > 0).astype(np.int32)
  batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
  for i in range(50):
    params, state, loss = step(params, state, batch)
    if i % 10 == 0:
      print(f"step {i:3d}  loss {float(loss):.4f}")

  # Root-solve health, scraped from optimizer state (TensorBoard-ready):
  metrics = state.stats[2]["w"].training_metrics
  print("max root error:", float(jnp.max(metrics.error)))


if __name__ == "__main__":
  main()
