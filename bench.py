"""Shampoo optimizer step time on the 58.7M-parameter fixture, on one GPU.

Times one complete distributed-Shampoo update (statistics EMA, batched
inverse p-th roots, grafted and preconditioned transform) on a
transformer-shaped parameter tree at block size 128, in two
configurations:

  * ``ours``: a root solve every step (the solver path end to end);
  * ``ours_steady``: a solve every 10 steps with warm-started re-solves
    (``reuse_preconditioner=True``), the interval regime training jobs run
    (reference guidance: `distributed_shampoo.py:1917-1928`).

Each sample runs k optimizer steps inside one jitted ``fori_loop`` and
waits with ``block_until_ready``; the per-step time is
``(t[k] - t[1]) / (k - 1)``, so dispatch and launch overhead cancel.  The
two configurations' rounds alternate and each reports its minimum.

Run:  python bench.py
Prints the device lines, then one JSON line.  Exits non-zero without a
number when JAX finds no GPU.
"""

import json
import time

import numpy as np

import jax
import jax.numpy as jnp


def _param_tree(rng):
  """Transformer-shaped tree: ~58.7M params, blocked and small tensors."""
  d, ff, vocab, layers = 1024, 4096, 8192, 4
  tree = {"embed": jnp.asarray(rng.randn(vocab, d) * 0.02, jnp.float32)}
  for i in range(layers):
    tree[f"blk{i}"] = {
        "qkv": jnp.asarray(rng.randn(d, 3 * d) * 0.02, jnp.float32),
        "out": jnp.asarray(rng.randn(d, d) * 0.02, jnp.float32),
        "ffn_in": jnp.asarray(rng.randn(d, ff) * 0.02, jnp.float32),
        "ffn_out": jnp.asarray(rng.randn(ff, d) * 0.02, jnp.float32),
        "norm": jnp.asarray(np.ones(d), jnp.float32),
    }
  return tree


def device_fixture(tree_fn=_param_tree):
  """(params, grads) with the shapes of ``tree_fn``, generated on device."""
  shapes, treedef = jax.tree.flatten(
      jax.eval_shape(lambda: tree_fn(np.random.RandomState(0))))

  @jax.jit
  def gen(key):
    keys = jax.random.split(key, 2 * len(shapes))
    params = [0.02 * jax.random.normal(k, s.shape, s.dtype)
              for k, s in zip(keys[:len(shapes)], shapes)]
    grads = [0.01 * jax.random.normal(k, s.shape, s.dtype)
             for k, s in zip(keys[len(shapes):], shapes)]
    return (jax.tree.unflatten(treedef, params),
            jax.tree.unflatten(treedef, grads))

  return jax.block_until_ready(gen(jax.random.PRNGKey(0)))


HYPERS = dict(
    learning_rate=0.1,
    block_size=128,
    beta1=0.9,
    beta2=0.999,
    matrix_epsilon=1e-6,
    start_preconditioning_step=0,
    statistics_compute_steps=1,
)


def make_tx(**overrides):
  """`distributed_shampoo` with the fixture's hyper-parameters."""
  from precondition_tpu.optim import shampoo

  return shampoo.distributed_shampoo(
      **{**HYPERS, **overrides}, graft_type=shampoo.GraftingType.RMSPROP,
      generate_training_metrics=False)


# name -> (optimizer overrides, steps per sample, settle steps).  A window
# of 10 consecutive steps holds exactly one solve whatever the phase, and
# 21 settle steps pass two solve cycles so warm starts see warm roots.
CONFIGS = {
    "ours": (dict(preconditioning_compute_steps=1), 8, 3),
    "ours_steady": (dict(preconditioning_compute_steps=10,
                         reuse_preconditioner=True), 11, 21),
}


def _steps_program(tx):
  """One jitted program running k optimizer steps as a device-side loop.

  ``k`` is a traced argument: every window size reuses one executable.
  """
  def run(state, k, grads, params):
    def body(_, st):
      _, st2 = tx.update(grads, st, params)
      return st2
    return jax.lax.fori_loop(0, k, body, state)

  return jax.jit(run)


class _Candidate:
  """A compiled k-step optimizer program plus its settled state."""

  def __init__(self, name, tx, params, grads, settle_steps):
    self.name = name
    self.params, self.grads = params, grads
    state = jax.jit(tx.init)(params)
    t0 = time.perf_counter()
    # k=8 is a python int, as at every call site: same aval, one program.
    self.run = _steps_program(tx).lower(state, 8, grads, params).compile()
    self.compile_s = time.perf_counter() - t0
    self.state = jax.block_until_ready(
        self.run(state, settle_steps, grads, params))

  def sample(self, iters):
    """One ``(t[k=iters] - t[k=1]) / (iters - 1)`` per-step seconds sample."""
    t0 = time.perf_counter()
    jax.block_until_ready(self.run(self.state, iters, self.grads, self.params))
    t_many = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(self.run(self.state, 1, self.grads, self.params))
    t_one = time.perf_counter() - t0
    return max(t_many - t_one, 1e-9) / (iters - 1)


def _measure_pair(candidates, iters, rounds):
  """Minimum per-step seconds of each candidate over alternating rounds.

  ``iters`` maps a candidate's name to its steps per sample.
  """
  best = {c.name: float("inf") for c in candidates}
  for _ in range(rounds):
    for c in candidates:
      best[c.name] = min(best[c.name], c.sample(iters[c.name]))
  return best


def main():
  from precondition_tpu.utils import runtime

  gpu = runtime.gpu_name_and_power_limit()
  devices = runtime.require_gpu()
  cache = runtime.enable_compile_cache()
  print(f"gpu: {gpu}")
  print(f"device: {json.dumps(runtime.device_summary(devices))} "
        f"jax={jax.__version__} compile_cache={cache}", flush=True)

  params, grads = device_fixture()
  candidates = [
      _Candidate(name, make_tx(**overrides), params, grads, settle)
      for name, (overrides, _, settle) in CONFIGS.items()]
  best = _measure_pair(
      candidates, {n: it for n, (_, it, _) in CONFIGS.items()}, rounds=4)
  print(json.dumps({
      "metric": "shampoo_step_time_58M_block128",
      "value": best["ours"] * 1e3,
      "steady_ms": best["ours_steady"] * 1e3,
      "unit": "ms",
      "compile_s": {c.name: c.compile_s for c in candidates},
      "device": runtime.device_summary(devices),
      "gpu": gpu,
  }))


if __name__ == "__main__":
  main()
