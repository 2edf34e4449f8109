"""Loose-vs-tight cold power-iteration policy: training-trajectory A/B.

A loose 1% relative power-iteration exit for cold inverse-root solves
gave identical root errors to the tight exit on a single probe batch.  The
estimate only scales the relative ridge and power iteration converges
from below, so theory says a loose exit solves a slightly harder — never
a wronger — problem; this experiment guards the policy at the TRAINING
level, where ill-conditioned statistics regimes the probe batch doesn't
cover would surface as trajectory divergence.

Trains the repo transformer byte-LM (same fixture corpora and harness as
`tearfree_backend_trajectory.py`) under core distributed_shampoo with
the cold power iteration at the reference's tight absolute 1e-6 exit vs
the loose relative 1e-2 exit (`pth_root.COLD_POWER_ITERATION_TOLERANCE`),
two seeds each.  Verdict rule as in the tearfree experiment: policies
"agree within noise" when the tight-vs-loose loss gap stays within 3x
the seed-to-seed gap.

Writes PI_POLICY_TRAJ.json at the repo root;
`tests/test_gap_modules.py` asserts the committed artifact's verdict.

Run (CPU):  JAX_PLATFORMS=cpu python benchmarks/pi_policy_trajectory.py
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
from precondition_tpu.ops import pth_root
from precondition_tpu.optim import shampoo

from benchmarks.tearfree_backend_trajectory import _batches, _byte_corpus


def _run(policy, steps, seed, cfg, stream):
  # The knob is read at trace time; each arm builds and jits fresh
  # programs, so setting it before construction is sufficient.
  pth_root.COLD_POWER_ITERATION_TOLERANCE = (
      1e-2 if policy == "loose" else None)
  try:
    tx = shampoo.distributed_shampoo(
        learning_rate=3e-3, block_size=64,
        graft_type=shampoo.GraftingType.RMSPROP,
        start_preconditioning_step=10,
        preconditioning_compute_steps=5,
        generate_training_metrics=False)
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
  finally:
    pth_root.COLD_POWER_ITERATION_TOLERANCE = None


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--steps", type=int, default=800)
  ap.add_argument("--out", default=os.path.join(
      os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
      "PI_POLICY_TRAJ.json"))
  args = ap.parse_args()

  cfg = transformer.TransformerConfig(
      vocab_size=256, d_model=128, n_heads=4, n_layers=2, d_ff=256,
      max_seq_len=64, remat=False)
  stream = _byte_corpus()

  t0 = time.time()
  runs = {}
  for policy in ("tight", "loose"):
    for seed in (0, 1):
      label = f"{policy}_seed{seed}"
      t1 = time.time()
      runs[label] = _run(policy, args.steps, seed, cfg, stream)
      print(f"[pi-traj] {label}: final loss {runs[label][-1]:.4f} "
            f"({time.time() - t1:.0f}s)", flush=True)

  t0_, t1_ = (np.asarray(runs[f"tight_seed{s}"]) for s in (0, 1))
  l0, l1 = (np.asarray(runs[f"loose_seed{s}"]) for s in (0, 1))
  tail = slice(args.steps // 3, None)
  gap = float(np.mean([np.mean(np.abs(t0_[tail] - l0[tail])),
                       np.mean(np.abs(t1_[tail] - l1[tail]))]))
  noise = float(np.mean([np.mean(np.abs(t0_[tail] - t1_[tail])),
                         np.mean(np.abs(l0[tail] - l1[tail]))]))
  verdict = "agree_within_noise" if gap <= 3.0 * noise else "diverge"

  artifact = {
      "platform": jax.devices()[0].platform,
      "steps": args.steps,
      "model": "transformer d128 L2 ff256 byte-LM on fixture corpora",
      "optimizer": ("distributed_shampoo block64 precond_freq5 "
                    "rmsprop-graft lr3e-3 start_precond 10"),
      "final_loss": {k: v[-1] for k, v in runs.items()},
      "mean_tail_loss": {k: float(np.mean(np.asarray(v)[tail]))
                         for k, v in runs.items()},
      "gap_tight_vs_loose": gap,
      "gap_seed_noise": noise,
      "verdict": verdict,
      "loss_curves_every10": {k: [round(x, 4) for x in v[::10]]
                              for k, v in runs.items()},
      "elapsed_s": round(time.time() - t0, 1),
  }
  with open(args.out, "w") as f:
    json.dump(artifact, f, indent=1)
  print(json.dumps({k: artifact[k] for k in (
      "gap_tight_vs_loose", "gap_seed_noise", "verdict", "final_loss")}))


if __name__ == "__main__":
  main()
