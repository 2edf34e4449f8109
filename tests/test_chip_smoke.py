"""chip_smoke.py on the CPU: its phases at tiny sizes, its option handling
and its refusal to report anything without a GPU.

The script's real run needs a GPU; here each phase function runs at a tiny
configuration on the virtual CPU devices of conftest.py.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from precondition_tpu.models import transformer
from precondition_tpu.utils import runtime

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_cfg():
  return transformer.TransformerConfig(
      vocab_size=256, d_model=128, n_heads=4, n_layers=1, d_ff=256,
      max_seq_len=32)


def _tiny_tree(rng):
  return {"embed": jnp.asarray(rng.randn(8192, 128), jnp.float32),
          "blk": {"qkv": jnp.asarray(rng.randn(128, 384), jnp.float32),
                  "norm": jnp.asarray(np.ones(128), jnp.float32)}}


def test_cpu_platform_exits_nonzero_without_result():
  env = dict(os.environ, JAX_PLATFORMS="cpu")
  out = subprocess.run(
      [sys.executable, os.path.join(_ROOT, "chip_smoke.py")],
      capture_output=True, text=True, timeout=300, env=env, cwd=_ROOT)
  assert out.returncode != 0
  assert '"ok"' not in out.stdout, out.stdout


def test_result_line_has_exactly_ok_and_device():
  line = json.loads(chip_smoke.result_line(jax.devices()))
  assert set(line) == {"ok", "device"}
  assert line["ok"] is True
  assert line["device"] == {"platform": "cpu",
                            "kind": jax.devices()[0].device_kind,
                            "count": len(jax.devices())}


def test_synthetic_batches_follow_one_bigram_map():
  cfg = _tiny_cfg()
  batches = chip_smoke.synthetic_batches(cfg, 4, 3)
  assert len(batches) == 3
  succ = {}
  for b in batches:
    tokens = np.asarray(b["tokens"])
    assert tokens.shape == (4, cfg.max_seq_len + 1)
    for a, c in zip(tokens[:, :-1].ravel(), tokens[:, 1:].ravel()):
      assert succ.setdefault(a, c) == c
  again = chip_smoke.synthetic_batches(cfg, 4, 3)
  np.testing.assert_array_equal(batches[2]["tokens"], again[2]["tokens"])


def test_train_phase_loss_falls():
  out = chip_smoke.train_phase(_tiny_cfg(), 4, jax.devices(), lr=3e-5)
  assert len(out["losses"]) == chip_smoke.TRAIN_STEPS
  assert out["losses"][-1] < out["losses"][0]
  assert out["params"] > 0 and out["compile_s"] > 0


def test_train_phase_raises_when_loss_does_not_fall(monkeypatch):
  # One batch repeated at learning rate 0: every loss is the same.
  one = chip_smoke.synthetic_batches(_tiny_cfg(), 4, 1)
  monkeypatch.setattr(chip_smoke, "synthetic_batches",
                      lambda cfg, b, steps: one * steps)
  with pytest.raises(AssertionError, match="loss did not fall"):
    chip_smoke.train_phase(_tiny_cfg(), 4, jax.devices(), lr=0.0)


def test_optimizer_phase_returns_exponent_four_stack(capsys):
  params, grads = bench.device_fixture(_tiny_tree)
  configs = chip_smoke.optimizer_configs()
  stats = chip_smoke.optimizer_phase(params, grads, configs)
  # qkv [128, 384] at block 128: 3 blocks x 2 axes; the embedding (> 4096)
  # and the norm vector (exponent 2) are not in the batch.
  assert stats.shape == (6, 128, 128)
  lines = [l for l in capsys.readouterr().out.splitlines()
           if l.startswith("optimizer ")]
  assert [json.loads(l.split(" ", 1)[1])["config"] for l in lines] == list(
      configs)


def test_reference_phase_passes_on_optimizer_statistics():
  params, grads = bench.device_fixture(_tiny_tree)
  tx = bench.make_tx()
  state = bench._steps_program(tx)(tx.init(params), 3, grads, params)
  stats = chip_smoke.stacked_statistics(state)
  roots = chip_smoke.stacked_statistics(state, field="preconditioners")
  assert stats.shape == roots.shape == (6, 128, 128)
  chip_smoke.reference_phase(stats, (128, 256))


def test_four_phase_on_four_virtual_devices(capsys):
  chip_smoke.four_phase(_tiny_cfg(), 4, jax.devices()[:4])
  modes = [json.loads(l.split(" ", 1)[1])
           for l in capsys.readouterr().out.splitlines()
           if l.startswith("four ")]
  assert [m["mode"] for m in modes] == ["distributed_solve", "zero_sharded"]
  assert all(m["devices"] == 4 for m in modes)


def test_update_gaps_read_lost_and_flipped_updates():
  rng = np.random.RandomState(0)
  p0 = {"a": rng.randn(8, 4), "b": rng.randn(3)}
  d = {"a": 1e-4 * rng.randn(8, 4), "b": 1e-4 * rng.randn(3)}
  p1 = jax.tree.map(np.add, p0, d)
  lost = {"a": p1["a"], "b": p0["b"]}
  flipped = {"a": p0["a"] - d["a"], "b": p1["b"]}
  assert chip_smoke.update_gaps(p0, p1, p1) == {"['a']": 0.0, "['b']": 0.0}
  np.testing.assert_allclose(
      chip_smoke.update_gaps(p0, lost, p1)["['b']"], 1.0)
  np.testing.assert_allclose(
      chip_smoke.update_gaps(p0, flipped, p1)["['a']"], 2.0)


def test_four_phase_fails_when_one_leaf_update_is_lost(monkeypatch):
  """A planted fault: the mesh run drops one leaf's update."""
  train = chip_smoke.__graft_entry__.train_distributed

  def drop_final_norm_update(cfg, devices, batches, **kw):
    losses, params = train(cfg, devices, batches, **kw)
    if len(devices) > 1:
      params["final_norm"]["scale"] = np.asarray(
          transformer.init_params(jax.random.PRNGKey(0), cfg)[
              "final_norm"]["scale"])
    return losses, params

  monkeypatch.setattr(chip_smoke.__graft_entry__, "train_distributed",
                      drop_final_norm_update)
  with pytest.raises(AssertionError, match=r"update gap 1\.0.*final_norm"):
    chip_smoke.four_phase(_tiny_cfg(), 4, jax.devices()[:4])


def _record_phases(monkeypatch):
  calls = []
  monkeypatch.setattr(runtime, "gpu_name_and_power_limit",
                      lambda: "Fake GPU, 700.00 W")
  monkeypatch.setattr(runtime, "require_gpu", jax.devices)
  monkeypatch.setattr(runtime, "enable_compile_cache", lambda: "unset")
  monkeypatch.setattr(bench, "device_fixture", lambda: (None, None))
  for name in ("train_phase", "optimizer_phase", "reference_phase",
               "four_phase", "optimizer_configs"):
    monkeypatch.setattr(chip_smoke, name,
                        lambda *a, _n=name, **k: calls.append(_n))
  return calls


def test_four_selects_only_the_four_card_phase(monkeypatch, capsys):
  calls = _record_phases(monkeypatch)
  chip_smoke.main(["--four"])
  assert calls == ["four_phase"]
  out = capsys.readouterr().out.splitlines()
  assert "Fake GPU, 700.00 W" in out[-2]
  assert json.loads(out[-1])["ok"] is True


def test_default_runs_the_single_card_phases(monkeypatch, capsys):
  calls = _record_phases(monkeypatch)
  chip_smoke.main([])
  assert calls == ["train_phase", "optimizer_configs", "optimizer_phase",
                   "reference_phase"]
  assert json.loads(capsys.readouterr().out.splitlines()[-1])["device"][
      "count"] == len(jax.devices())
