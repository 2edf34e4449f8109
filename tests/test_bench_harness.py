"""Guards for the step-time benchmark (bench.py).

bench.py's fixture is GPU-sized; these tests exercise its timing machinery
on a tiny problem, and its refusal to run anywhere but on a GPU.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

import bench
from precondition_tpu.optim import shampoo

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny():
  params = {"w": jnp.asarray(np.random.RandomState(0).randn(32, 24),
                             jnp.float32)}
  grads = jax.tree.map(lambda p: p * 0.01, params)
  tx = shampoo.distributed_shampoo(
      learning_rate=0.1, block_size=8, start_preconditioning_step=0,
      generate_training_metrics=False)
  return tx, params, grads


class TestBenchHarness:

  def test_measure_pair_returns_positive_per_step(self):
    tx, params, grads = _tiny()
    cands = [bench._Candidate("a", tx, params, grads, settle_steps=2),
             bench._Candidate("b", tx, params, grads, settle_steps=2)]
    best = bench._measure_pair(cands, {"a": 3, "b": 4}, rounds=2)
    assert set(best) == {"a", "b"}
    for v in best.values():
      assert 0 < v < 60

  def test_steps_program_advances_count(self):
    tx, params, grads = _tiny()
    run = bench._steps_program(tx)
    state = run(tx.init(params), 5, grads, params)
    assert int(state.count) == 5

  def test_candidate_sample_reuses_compiled_program(self):
    # k is a traced argument: every window size reuses one executable, so
    # the AOT-compiled program accepts any k.
    tx, params, grads = _tiny()
    cand = bench._Candidate("a", tx, params, grads, settle_steps=2)
    assert int(cand.state.count) == 2
    assert cand.compile_s > 0
    s1 = cand.sample(3)
    s2 = cand.sample(5)
    assert s1 > 0 and s2 > 0

  def test_param_tree_shape_is_stable(self):
    # The recorded metric's fixture: keep it identical across PRs so the
    # step times stay comparable (~58.7M params).
    shapes = jax.eval_shape(
        lambda: bench._param_tree(np.random.RandomState(0)))
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(shapes))
    assert n == 58_724_352

  def test_device_fixture_matches_tree_shapes(self):
    def tree(rng):
      return {"a": jnp.asarray(rng.randn(4, 6), jnp.float32),
              "b": jnp.ones(3)}

    params, grads = bench.device_fixture(tree)
    for x in (params, grads):
      assert jax.tree.map(jnp.shape, x) == {"a": (4, 6), "b": (3,)}
    assert not np.allclose(params["a"], grads["a"])

  def test_make_tx_overrides_hypers(self):
    # An override replaces the fixture's value instead of colliding with it.
    tx = bench.make_tx(block_size=64)
    state = tx.init({"w": jnp.zeros((64, 128))})
    assert state.stats["w"].statistics[0].shape == (2, 64, 64)

  def test_steady_window_holds_one_solve(self):
    overrides, iters, settle = bench.CONFIGS["ours_steady"]
    assert iters - 1 == overrides["preconditioning_compute_steps"]
    assert settle > 2 * overrides["preconditioning_compute_steps"]

  def test_refuses_cpu(self):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "bench.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=_ROOT)
    assert out.returncode != 0
    assert '"value"' not in out.stdout and "ms" not in out.stdout, out.stdout
