"""Time of the XLA inverse-root solve on the optimizer's own statistics.

The batch is the `ShampooRootSolve` batch of exponent 4 that
`distributed_shampoo` solves on `bench.py`'s 58.7M-param fixture: every
[m, m] statistic of the 2-D parameters, after a few settle steps.  Three
cases: block 128 cold; block 128 warm-started from the previous step's
roots (``reuse_preconditioner``); block 1024 cold.

FLOPs count the coupled-Newton matmuls the batch executes: under vmap
every member runs as many iterations as the slowest, and at p=4 one
iteration is 4 [m, m] matmuls (T^2, T^4, T^4 M, H T).  Power iteration and
the warm start's set-up matmuls are left out.  The solve asks for
``Precision.HIGHEST``, so the rate is set against the H100's published
67 TF/s of float32 outside the tensor cores.

Run:  python benchmarks/solve_timing.py     (GPU; prints one JSON line per case)
"""

import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from precondition_tpu.ops import pth_root  # noqa: E402
from precondition_tpu.utils import runtime  # noqa: E402

FP32_PEAK_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
REPEATS = 5


def settled_batches(params, grads, block_size, settle_steps=21):
  """(stats at step k+1, roots of the stats at step k), both stacked.

  With constant gradients the statistics grow like k, so step k+1 moves
  them by ~1/k; past ~20 steps the warm start's certificate accepts the
  previous roots.
  """
  tx = bench.make_tx(block_size=block_size, preconditioning_compute_steps=1)
  run = bench._steps_program(tx)
  state = run(jax.jit(tx.init)(params), settle_steps, grads, params)
  prevs = chip_smoke.stacked_statistics(state, field="preconditioners")
  state = run(state, 1, grads, params)
  return chip_smoke.stacked_statistics(state), prevs


def time_solve(stats, prevs=None, p=4):
  """Median seconds of one jitted batched solve, and its metrics."""
  pads = jnp.full((stats.shape[0],), stats.shape[-1], jnp.int32)
  solve = jax.jit(lambda s, w: pth_root.batched_inverse_pth_root(
      s, p, pads, prevs=w))
  t0 = time.perf_counter()
  _, metrics = jax.block_until_ready(solve(stats, prevs))
  compile_s = time.perf_counter() - t0
  times = []
  for _ in range(REPEATS):
    t0 = time.perf_counter()
    jax.block_until_ready(solve(stats, prevs))
    times.append(time.perf_counter() - t0)
  return statistics.median(times), compile_s, metrics


def main():
  gpu = runtime.gpu_name_and_power_limit()
  runtime.require_gpu()
  runtime.enable_compile_cache()
  print(f"gpu: {gpu}", flush=True)
  params, grads = bench.device_fixture()
  for block, warm in ((128, False), (128, True), (1024, False)):
    stats, prevs = settled_batches(params, grads, block)
    seconds, compile_s, metrics = time_solve(stats, prevs if warm else None)
    n, m = stats.shape[0], stats.shape[-1]
    iters = float(jnp.max(metrics.iterations))
    flops = n * iters * 4 * 2 * m ** 3
    print(json.dumps({
        "case": f"block{block}_{'warm' if warm else 'cold'}",
        "batch": [n, m, m], "ms": seconds * 1e3, "compile_s": compile_s,
        "iterations_max": iters,
        "iterations_mean": float(jnp.mean(metrics.iterations)),
        "retries_max": float(jnp.max(metrics.retries)),
        "newton_flops": flops, "tflops_per_s": flops / seconds / 1e12,
        "share_of_fp32_peak": flops / seconds / FP32_PEAK_FLOPS,
        "gpu": gpu}), flush=True)


if __name__ == "__main__":
  main()
