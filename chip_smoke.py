"""One pass over the main path on a GPU, with its results checked.

Phases, each printing its numbers on one line:

  device     the card (nvidia-smi, before JAX touches it) and JAX's view;
  train      the flagship transformer (~68M params) trained for 5 steps
             with distributed Shampoo through `train/loop.py`;
  optimizer  `distributed_shampoo` updates on the 58.7M-param fixture at
             block 128 (solve every step, and every 10 steps warm-started)
             and block 1024, then one `tearfree` update;
  reference  the solver's roots of the optimizer's own statistics against
             a host float64 eigh root, and one Shampoo update on the GPU
             against the same update on the CPU.

With ``--four`` it runs only the four-card path: the distributed-solve and
ZeRO-sharded-state training modes on a 4-card mesh, each against the same
steps on card 0.

Run:  python chip_smoke.py          (one GPU)
      python chip_smoke.py --four   (four GPUs)
The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it, and so does a run where JAX finds no GPU.
"""

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np

import jax
from jax import lax
import jax.numpy as jnp

import __graft_entry__
import bench
from benchmarks import numerics_check
from precondition_tpu import tearfree
from precondition_tpu.models import transformer
from precondition_tpu.ops import pth_root
from precondition_tpu.optim import shampoo
from precondition_tpu.parallel import mesh as mesh_lib
from precondition_tpu.tearfree import grafting, second_order
from precondition_tpu.tearfree import shampoo as tf_shampoo
from precondition_tpu.train import loop as train_loop
from precondition_tpu.utils import runtime

LR = 1e-5
TRAIN_STEPS = 5
FOUR_STEPS = 3
# Largest `update_gaps` reading the four-card comparison accepts.
FOUR_UPDATE_LIMIT = 0.1
# Members of the reference phase's condition-number spread.
SPREAD_MEMBERS = 63


def flagship_config():
  """The widest transformer the repo runs: bench.py's fixture widths."""
  return transformer.TransformerConfig(
      vocab_size=8192, d_model=1024, n_heads=16, n_layers=4, d_ff=4096,
      max_seq_len=1024)


def synthetic_batches(cfg, batch_size, steps):
  """Seeded next-token task the model can learn: a fixed random bigram map.

  Each row starts at a random token and follows ``next = perm[token]``.
  """
  rng = np.random.RandomState(0)
  perm = rng.permutation(cfg.vocab_size)
  batches = []
  for _ in range(steps):
    tokens = np.empty((batch_size, cfg.max_seq_len + 1), np.int32)
    tokens[:, 0] = rng.randint(0, cfg.vocab_size, batch_size)
    for t in range(cfg.max_seq_len):
      tokens[:, t + 1] = perm[tokens[:, t]]
    batches.append({"tokens": jnp.asarray(tokens)})
  return batches


def _emit(phase, numbers):
  print(f"{phase} {json.dumps(numbers)}", flush=True)


def _peak_bytes(device):
  stats = device.memory_stats()
  return stats.get("peak_bytes_in_use") if stats else None


def train_phase(cfg, batch_size, devices, lr=LR):
  """Trains ``cfg`` for `TRAIN_STEPS` steps on a one-device mesh.

  Requires finite losses and a last loss below the first.
  """
  mesh = mesh_lib.make_mesh((1, 1), devices=devices[:1])
  params = mesh_lib.shard_params(
      transformer.init_params(jax.random.PRNGKey(0), cfg), mesh,
      transformer.TP_RULES)
  tx = shampoo.distributed_shampoo(
      learning_rate=lr, block_size=128,
      graft_type=shampoo.GraftingType.RMSPROP,
      start_preconditioning_step=0, preconditioning_compute_steps=1)
  opt_state = jax.jit(tx.init)(params)
  step = train_loop.make_sharded_train_step(
      lambda p, b: transformer.loss_fn(p, b, cfg), tx, mesh,
      transformer.TP_RULES)
  batches = synthetic_batches(cfg, batch_size, TRAIN_STEPS)
  t0 = time.perf_counter()
  compiled = step.lower(params, opt_state, batches[0]).compile()
  compile_s = time.perf_counter() - t0
  losses, step_s = [], []
  for batch in batches:
    t0 = time.perf_counter()
    loss, params, opt_state = jax.block_until_ready(
        compiled(params, opt_state, batch))
    step_s.append(time.perf_counter() - t0)
    losses.append(float(loss))
  n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
  out = {
      "params": n_params,
      "batch": [batch_size, cfg.max_seq_len],
      "compile_s": compile_s,
      "step_ms_median_2_to_last": statistics.median(step_s[1:]) * 1e3,
      "losses": losses,
      "peak_bytes_in_use": _peak_bytes(devices[0]),
  }
  _emit("train", out)
  if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
    raise AssertionError(f"train: loss did not fall: {losses}")
  return out


def optimizer_configs():
  """name -> (transformation, steps per timing sample, settle steps)."""
  tearfree_tx = tearfree.tearfree(
      bench.HYPERS["learning_rate"],
      tearfree.TearfreeOptions(
          grafting_options=grafting.Options(
              grafting_type=grafting.GraftingType.RMSPROP),
          second_order_options=second_order.Options(
              shampoo_options=tf_shampoo.Options(block_size=128))))
  return {
      "shampoo_b128_every1": (
          bench.make_tx(preconditioning_compute_steps=1), 8, 3),
      "shampoo_b128_every10_warm": (
          bench.make_tx(preconditioning_compute_steps=10,
                        reuse_preconditioner=True), 11, 21),
      "shampoo_b1024_every1": (
          bench.make_tx(block_size=1024, preconditioning_compute_steps=1),
          4, 3),
      "tearfree_b128_auto": (tearfree_tx, 4, 3),
  }


def stacked_statistics(state, rank=2, field="statistics"):
  """The optimizer's stacked ``[N, m, m]`` statistics of rank-``rank`` params.

  Those share the root exponent ``2 * rank``: the `ShampooRootSolve`
  batch of that exponent.  ``field="preconditioners"`` gives their roots.
  """
  per_param = jax.tree.leaves(
      state.stats, is_leaf=lambda x: isinstance(x, shampoo.ParameterStats))
  stacks = [s for ps in per_param
            if len(ps.statistics) == rank and ps.statistics[0].ndim == 3
            for s in getattr(ps, field)]
  return jnp.concatenate(stacks)


def optimizer_phase(params, grads, configs):
  """Compiles and times each optimizer configuration on (params, grads).

  Returns the stacked statistics of the first configuration's settled
  state, for the reference phase.
  """
  stats = None
  for name, (tx, iters, settle) in configs.items():
    cand = bench._Candidate(name, tx, params, grads, settle)
    best = bench._measure_pair([cand], {name: iters}, rounds=2)
    leaves = jax.tree.leaves(cand.state)
    if not all(bool(jnp.all(jnp.isfinite(x))) for x in leaves
               if jnp.issubdtype(x.dtype, jnp.floating)):
      raise AssertionError(f"optimizer: non-finite state in {name}")
    _emit("optimizer", {"config": name, "compile_s": cand.compile_s,
                        "step_ms": best[name] * 1e3,
                        "steps_per_sample": iters})
    if stats is None:
      stats = stacked_statistics(cand.state)
    del cand
  return stats


def reference_phase(stats, update_shape, p=4):
  """Numerics on the device against float64 and CPU references.

  (a) roots of ``stats`` (``[N, m, m]``, exponent ``p``) against host
  float64 eigh roots of the same ridge-regularized matrices, plus their
  true residuals (`benchmarks/numerics_check.py`); the same for a seeded
  batch with condition numbers from 1e2 to 1e6 and one near-singular
  member that climbs the ridge ladder, which the optimizer's
  well-conditioned statistics never reach;
  (b) one Shampoo update of an ``update_shape`` parameter here and on the
  CPU device of this process, both at float32 ("highest") matmul
  precision: max |du| <= 1e-3 max |u|.  The iterative float32 solver
  stops after a data-dependent number of iterations, so the devices may
  differ in the last bits.  The difference at default precision is
  printed for information only.
  """
  failures = []
  spread = numerics_check.spread_batch(
      np.random.RandomState(0), SPREAD_MEMBERS, stats.shape[-1])
  for name, batch in (("reference_roots", stats),
                      ("reference_spread", spread)):
    pads = jnp.full((batch.shape[0],), batch.shape[-1], jnp.int32)
    roots, metrics = jax.jit(
        lambda s, pads=pads: pth_root.batched_inverse_pth_root(s, p, pads))(
            batch)
    t0 = time.perf_counter()
    summary, fails = numerics_check.compare_with_host(
        roots, batch, metrics, p)
    summary["host_seconds"] = time.perf_counter() - t0
    _emit(name, summary)
    failures += [f"{name}: {f}" for f in fails]
  if summary["retries_max"] < 2:
    failures.append("reference_spread: the near-singular member did not "
                    "climb the ridge ladder")

  rng = np.random.RandomState(1)
  param = rng.randn(*update_shape).astype(np.float32) * 0.02
  grad = rng.randn(*update_shape).astype(np.float32) * 0.01

  def update_on(device, precise):
    tx = bench.make_tx(
        tensordot_precision=lax.Precision.HIGHEST if precise else None)
    x = {"w": jax.device_put(param, device)}
    g = {"w": jax.device_put(grad, device)}
    with jax.default_matmul_precision("highest" if precise else None):
      fn = jax.jit(lambda g, x: tx.update(g, tx.init(x), x)[0]["w"])
      return np.asarray(fn(g, x))

  here, cpu = jax.devices()[0], jax.devices("cpu")[0]
  u_cpu = update_on(cpu, True)
  scale = float(np.max(np.abs(u_cpu)))
  diff = float(np.max(np.abs(update_on(here, True) - u_cpu)))
  diff_default = float(np.max(np.abs(update_on(here, False) - u_cpu)))
  _emit("reference_update", {
      "shape": list(update_shape), "max_abs_u": scale,
      "max_abs_du_highest": diff, "rel_highest": diff / scale,
      "max_abs_du_default_precision": diff_default,
      "rel_default_precision": diff_default / scale})
  if diff > 1e-3 * scale:
    failures.append(f"update on {here.platform} vs cpu: max|du| {diff} > "
                    f"1e-3 * {scale}")
  if failures:
    raise AssertionError("reference: " + "; ".join(failures))


def update_gaps(params0, params_n, params_1):
  """Per leaf: ||(p_n - p0) - (p_1 - p0)|| / ||p_1 - p0|| (Frobenius).

  The gap between two runs' total updates relative to the reference
  run's: 0 when they agree, 1 when a leaf's update was lost, 2 when its
  sign flipped.  A norm over the leaf and not a max over entries: the
  RMSProp graft moves each entry by about ``lr / sqrt(1 - beta2)``
  whatever its gradient's size, so entries whose gradient is rounding
  noise (sums that cancel) take full-size steps of either sign, and no
  two correct float32 runs agree on them.
  """
  gaps = {}
  for (path, p0), pn, p1 in zip(
      jax.tree_util.tree_flatten_with_path(params0)[0],
      jax.tree.leaves(params_n), jax.tree.leaves(params_1)):
    d1 = np.asarray(p1, np.float64) - np.asarray(p0, np.float64)
    dn = np.asarray(pn, np.float64) - np.asarray(p0, np.float64)
    gaps[jax.tree_util.keystr(path)] = float(
        np.linalg.norm(dn - d1) / np.linalg.norm(d1))
  return gaps


def four_phase(cfg, batch_size, devices):
  """Distributed-solve and ZeRO modes on ``devices`` against card 0.

  Each mode trains `FOUR_STEPS` steps over the whole mesh and again on
  ``devices[0]`` alone, from the same seed and batches: losses must agree
  to 1e-3 relative and every leaf's total update to `FOUR_UPDATE_LIMIT`
  of its largest entry (`update_gaps`).  Both run with float32
  activations and float32 ("highest") matmuls, so the comparison sees the
  distribution and not bf16 rounding.
  """
  cfg = dataclasses.replace(cfg, dtype=jnp.float32)
  batches = synthetic_batches(cfg, batch_size, FOUR_STEPS)
  params0 = jax.device_get(
      transformer.init_params(jax.random.PRNGKey(0), cfg))
  failures = []
  for mode, zero in (("distributed_solve", False), ("zero_sharded", True)):
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
      losses_n, params_n = __graft_entry__.train_distributed(
          cfg, devices, batches, zero=zero, lr=LR)
      losses_1, params_1 = __graft_entry__.train_distributed(
          cfg, devices[:1], batches, zero=zero, lr=LR)
    loss_rel = float(np.max(np.abs(np.subtract(losses_n, losses_1))
                            / np.abs(losses_1)))
    gaps = update_gaps(params0, params_n, params_1)
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    _emit("four", {"mode": mode, "devices": len(devices),
                   "losses": losses_n, "losses_one_card": losses_1,
                   "loss_rel_diff_max": loss_rel,
                   "update_gap_max": gaps[worst[0]],
                   "worst_leaves": {k: gaps[k] for k in worst},
                   "seconds": time.perf_counter() - t0})
    if loss_rel > 1e-3 or gaps[worst[0]] > FOUR_UPDATE_LIMIT:
      failures.append(f"{mode}: loss rel {loss_rel}, update gap "
                      f"{gaps[worst[0]]} at {worst[0]}")
  if failures:
    raise AssertionError("four: " + "; ".join(failures))


def result_line(devices) -> str:
  return json.dumps({"ok": True, "device": runtime.device_summary(devices)})


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  parser.add_argument("--four", action="store_true",
                      help="run only the four-card path, on four GPUs")
  args = parser.parse_args(argv)

  gpu = runtime.gpu_name_and_power_limit()
  # The reference phase also needs this process's CPU device.
  platforms = jax.config.jax_platforms
  if platforms and "cpu" not in platforms.split(","):
    jax.config.update("jax_platforms", platforms + ",cpu")
  devices = runtime.require_gpu()
  if args.four and len(devices) < 4:
    raise SystemExit(f"--four needs 4 GPUs, found {len(devices)}")
  devices = devices[:4] if args.four else devices[:1]
  cache = runtime.enable_compile_cache()
  _emit("device", {"device": runtime.device_summary(devices),
                   "jax": jax.__version__,
                   "XLA_FLAGS": os.environ.get("XLA_FLAGS", ""),
                   "compile_cache": cache})
  print(f"gpu: {gpu}", flush=True)

  cfg = flagship_config()
  if args.four:
    four_phase(cfg, 8, devices)
  else:
    train_phase(cfg, 8, devices)
    params, grads = bench.device_fixture()
    stats = optimizer_phase(params, grads, optimizer_configs())
    del params, grads
    reference_phase(stats, (1024, 4096))
  print(result_line(jax.devices()), flush=True)


if __name__ == "__main__":
  sys.exit(main())
