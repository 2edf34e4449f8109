"""Tearfree solver-backend decision experiment: eigh vs newton trajectories.

The two batched inverse-root backends differ in null-space semantics —
``eigh`` zero-clips eigenvalues below ``1e-6 * lambda_max`` (upstream
parity, `/root/reference/precondition/tearfree/shampoo.py:466-474`),
``newton`` ridge-regularizes them (the flagship optimizer's semantics,
and a matmul-only solve).  Whether the framework may default to a
matmul-only backend is an *accuracy* question: do real training
trajectories diverge?

This experiment trains the repo transformer LM on the committed fixture
corpora (byte-level tokens from `tests/fixtures/datamix/*.jsonl`) under
tearfree/Shampoo with each backend, plus a seed-perturbed eigh control
run that calibrates run-to-run noise.  Verdict rule: the backends "agree
within noise" if the eigh-vs-newton loss gap stays within 3x the
eigh-seed0-vs-eigh-seed1 gap (3x: the control varies *initialization*,
the treatment varies only root regularization, so same-seed gaps
substantially above the control band would still flag a real effect).

Writes TEARFREE_BACKEND_TRAJ.json next to the repo root artifacts.

Run on CPU (the semantics are platform-independent):
  JAX_PLATFORMS=cpu python benchmarks/tearfree_backend_trajectory.py [--steps N]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from precondition_tpu.models import transformer
from precondition_tpu.tearfree import grafting
from precondition_tpu.tearfree import momentum
from precondition_tpu.tearfree import optimizer as tearfree_optimizer
from precondition_tpu.tearfree import second_order
from precondition_tpu.tearfree import shampoo as tearfree_shampoo

_FIXTURES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "fixtures", "datamix")


def _byte_corpus(max_bytes=400_000):
  """All fixture-corpus text as one uint8 token stream."""
  chunks = []
  total = 0
  for name in sorted(os.listdir(_FIXTURES)):
    if not name.endswith(".jsonl"):
      continue
    with open(os.path.join(_FIXTURES, name), "rb") as f:
      for line in f:
        try:
          rec = json.loads(line)
        except ValueError:
          continue
        text = " ".join(str(v) for v in rec.values() if isinstance(v, str))
        data = text.encode("utf-8")[:4096]
        chunks.append(np.frombuffer(data, np.uint8))
        total += len(data)
        if total >= max_bytes:
          break
    if total >= max_bytes:
      break
  stream = np.concatenate(chunks)
  assert stream.size > 10_000, "fixture corpora unexpectedly small"
  return stream


def _batches(stream, steps, batch, seq, seed):
  rng = np.random.RandomState(seed)
  starts = rng.randint(0, stream.size - seq - 1, size=(steps, batch))
  for s in starts:
    toks = np.stack([stream[i:i + seq + 1] for i in s]).astype(np.int32)
    yield {"tokens": toks}


def _make_tx(lr, backend, block_size):
  options = tearfree_optimizer.TearfreeOptions(
      grafting_options=grafting.Options(
          grafting_type=grafting.GraftingType.RMSPROP,
          second_moment_decay=0.999,
          start_preconditioning_step=10,
      ),
      second_order_options=second_order.Options(
          second_order_type=second_order.SecondOrderType.SHAMPOO,
          shampoo_options=tearfree_shampoo.Options(
              block_size=block_size,
              update_preconditioners_freq=5,
              second_moment_decay=0.999,
              solver_backend=backend,
          ),
      ),
      momentum_options=momentum.Options(momentum_decay=0.9),
  )
  return tearfree_optimizer.tearfree(lr, options)


def _run(backend, steps, seed, cfg, stream):
  tx = _make_tx(3e-3, backend, block_size=64)
  params = transformer.init_params(jax.random.PRNGKey(seed), cfg)
  state = tx.init(params)

  @jax.jit
  def step(params, state, batch):
    loss, grads = jax.value_and_grad(
        lambda p: transformer.loss_fn(p, batch, cfg))(params)
    updates, state2 = tx.update(grads, state, params)
    params2 = jax.tree.map(lambda p, u: p + u, params, updates)
    return loss, params2, state2

  losses = []
  for batch in _batches(stream, steps, batch=16, seq=64, seed=0):
    loss, params, state = step(params, state,
                               {"tokens": jnp.asarray(batch["tokens"])})
    losses.append(float(loss))
  return losses


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--steps", type=int, default=300)
  ap.add_argument("--out", default=os.path.join(
      os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
      "TEARFREE_BACKEND_TRAJ.json"))
  args = ap.parse_args()

  cfg = transformer.TransformerConfig(
      vocab_size=256, d_model=128, n_heads=4, n_layers=2, d_ff=256,
      max_seq_len=64, remat=False)
  stream = _byte_corpus()

  t0 = time.time()
  runs = {}
  for backend in ("eigh", "newton", "filtered"):
    for seed in (0, 1):
      label = f"{backend}_seed{seed}"
      t1 = time.time()
      runs[label] = _run(backend, args.steps, seed, cfg, stream)
      print(f"[traj] {label}: final loss {runs[label][-1]:.4f} "
            f"({time.time() - t1:.0f}s)", flush=True)

  e0, e1 = (np.asarray(runs[f"eigh_seed{s}"]) for s in (0, 1))
  # Compare on the tail (post-warmup, preconditioning active).
  tail = slice(args.steps // 3, None)
  gap_noise = float(np.mean(np.abs(e0[tail] - e1[tail])))

  def _gap_and_verdict(backend):
    b0, b1 = (np.asarray(runs[f"{backend}_seed{s}"]) for s in (0, 1))
    gap = float(np.mean([np.mean(np.abs(e0[tail] - b0[tail])),
                         np.mean(np.abs(e1[tail] - b1[tail]))]))
    noise = float(np.mean([np.mean(np.abs(e0[tail] - e1[tail])),
                           np.mean(np.abs(b0[tail] - b1[tail]))]))
    verdict = "agree_within_noise" if gap <= 3.0 * noise else "diverge"
    return gap, noise, verdict

  gap_newton, noise_newton, verdict_newton = _gap_and_verdict("newton")
  gap_filtered, noise_filtered, verdict_filtered = _gap_and_verdict(
      "filtered")

  artifact = {
      "platform": jax.devices()[0].platform,
      "steps": args.steps,
      "model": "transformer d128 L2 ff256 byte-LM on fixture corpora",
      "optimizer": ("tearfree shampoo block64 precond_freq5 rmsprop-graft "
                    "momentum0.9 lr3e-3 start_precond 10"),
      "final_loss": {k: v[-1] for k, v in runs.items()},
      "mean_tail_loss": {k: float(np.mean(np.asarray(v)[tail]))
                         for k, v in runs.items()},
      "gap_eigh_vs_newton": gap_newton,
      "gap_seed_noise": noise_newton,
      "verdict": verdict_newton,
      "gap_eigh_vs_filtered": gap_filtered,
      "gap_seed_noise_filtered": noise_filtered,
      "verdict_filtered": verdict_filtered,
      "loss_curves_every10": {k: [round(x, 4) for x in v[::10]]
                              for k, v in runs.items()},
      "elapsed_s": round(time.time() - t0, 1),
  }
  with open(args.out, "w") as f:
    json.dump(artifact, f, indent=1)
  print(json.dumps({k: artifact[k] for k in (
      "gap_eigh_vs_newton", "gap_eigh_vs_filtered", "gap_seed_noise",
      "verdict", "verdict_filtered", "final_loss")}))


if __name__ == "__main__":
  main()
