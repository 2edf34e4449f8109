"""Coverage for previously-untested support modules.

`utils.control` (lazy_cond gating), `utils.aot` (hardware-free compile
validation), `datamix.baselines` (random baseline / SNR / confusion
matrix over the bandit contracts), `oco.datasets` (synthetic + loss
math), and the generation/code evals driven by a fake sampler.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


class TestLazyCond:

  def test_false_keeps_state(self):
    from precondition_tpu.utils import control

    init = [jnp.arange(4.0), jnp.ones((2, 2))]
    out = jax.jit(lambda p, s: control.lazy_cond(
        p, lambda: [s[0] + 100.0, s[1] * 9.0], s))(jnp.asarray(False), init)
    np.testing.assert_array_equal(np.asarray(out[0]), np.arange(4.0))
    np.testing.assert_array_equal(np.asarray(out[1]), np.ones((2, 2)))

  def test_true_computes(self):
    from precondition_tpu.utils import control

    init = [jnp.arange(4.0)]
    out = jax.jit(lambda p, s: control.lazy_cond(
        p, lambda: [s[0] + 100.0], s))(jnp.asarray(True), init)
    np.testing.assert_array_equal(np.asarray(out[0]), np.arange(4.0) + 100.0)

  def test_tree_variant(self):
    from precondition_tpu.utils import control

    tree = {"a": jnp.zeros(3), "b": {"c": jnp.ones(2)}}
    out_t = jax.jit(lambda p: control.tree_lazy_cond(
        p, lambda: jax.tree.map(lambda x: x + 1, tree), tree))(
            jnp.asarray(True))
    np.testing.assert_array_equal(np.asarray(out_t["b"]["c"]), [2.0, 2.0])
    out_f = jax.jit(lambda p: control.tree_lazy_cond(
        p, lambda: jax.tree.map(lambda x: x + 1, tree), tree))(
            jnp.asarray(False))
    np.testing.assert_array_equal(np.asarray(out_f["a"]), np.zeros(3))


class TestAot:

  def test_compile_and_report_sharded(self):
    from precondition_tpu.utils import aot

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("data",))
    sharding = NamedSharding(mesh, P("data"))
    x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
    compiled = aot.aot_compile(
        lambda a: (a * 2).sum(axis=1), x,
        in_shardings=sharding, out_shardings=NamedSharding(mesh, P("data")))
    report = aot.compile_report(compiled)
    assert isinstance(report, dict) and report  # non-empty on CPU
    y = compiled(jax.device_put(x, sharding))
    np.testing.assert_allclose(np.asarray(y), np.asarray(x).sum(1) * 2)


class _StubGen:
  """Minimal training-batch-generator contract for the baselines."""

  def __init__(self, n):
    self.train_ds_builders = [object()] * n
    self.prepared = None

  def prepare_for_training(self, candidates, weights):
    self.prepared = [np.asarray(c, dtype=np.float64) for c in candidates]

  def get_next_batch(self, index=0):
    return self.prepared[index]


class _StubTrain:
  """train_loop returns the 'batch' (= candidate weights) as the params."""

  def train_loop(self, params, get_next_batch_fn):
    return {"params": get_next_batch_fn()}


class TestBaselines:

  def test_random_simplex(self):
    from precondition_tpu.datamix import baselines

    w = baselines.random_simplex(7, np.random.default_rng(0))
    assert w.shape == (7,) and np.all(w >= 0)
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-12)

  def test_random_baseline_tracks_best(self):
    from precondition_tpu.datamix import baselines

    target = np.array([0.6, 0.3, 0.1])
    gen = _StubGen(3)
    history = []
    best_w, best_score = baselines.random_baseline(
        eval_fn=lambda p: -float(np.sum((np.asarray(p) - target) ** 2)),
        train_obj=_StubTrain(),
        training_batch_generator_obj=gen,
        init_params=np.zeros(3),
        num_iterations=20, seed=1, history=history)
    assert len(history) == 20
    assert best_score == max(s for _, s in history)
    np.testing.assert_allclose(np.sum(best_w), 1.0, rtol=1e-12)

  def test_gradient_snr_deterministic_probe(self):
    from precondition_tpu.datamix import baselines

    target = np.array([0.5, 0.5])
    out = baselines.gradient_snr(
        eval_fn=lambda p: -float(np.sum((np.asarray(p) - target) ** 2)),
        train_obj=_StubTrain(),
        training_batch_generator_obj=_StubGen(2),
        init_params=np.zeros(2),
        weights=np.array([0.7, 0.3]),
        num_trials=4, seed=0)
    assert set(out) == {"mean", "std", "snr"}
    assert out["mean"].shape == (2,)
    assert np.all(np.isfinite(out["snr"]))

  def test_confusion_matrix_is_identity_under_stub(self, monkeypatch):
    from precondition_tpu.datamix import baselines, batch_generators

    class _OneBuilderGen:
      def __init__(self, builders, batch_size=8):
        self.builders = builders

      def prepare_for_training(self, candidates, weights):
        pass

      def get_next_batch(self, index=0):
        return self.builders[0]

    monkeypatch.setattr(batch_generators,
                        "VanillaTrainingBatchGenerator", _OneBuilderGen)
    builders = [0, 1, 2]
    evals = [  # eval j scores 1 iff trained on dataset j
        (lambda j: lambda p: float(p == j))(j) for j in range(3)]
    mat = baselines.mixture_confusion_matrix(
        evals, _StubTrain(), builders, init_params=None)
    np.testing.assert_array_equal(mat, np.eye(3))

  def test_deterministic_strategy_requires_dartboard(self):
    from precondition_tpu.datamix import baselines

    with pytest.raises(AssertionError):
      baselines.run_deterministic_strategy_bandit_loop(
          eval_fn=lambda p: 0.0, train_obj=_StubTrain(),
          training_batch_generator_obj=_StubGen(2))


class TestOcoDatasets:

  def test_synthetic_loads_and_losses(self):
    from precondition_tpu.oco import datasets

    ds = datasets.load_dataset("synthetic", cache="/tmp/oco_cache_test")
    dst = datasets.load_dataset("synthetic.t", cache="/tmp/oco_cache_test")
    assert ds.x.shape[1] == ds.w_shape[0]
    assert ds.y.dtype == bool
    assert not np.array_equal(ds.x[:5], dst.x[:5])  # different splits
    w = jnp.zeros(ds.w_shape)
    x0, y0 = jnp.asarray(ds.x[0]), jnp.asarray(ds.y[0])
    loss0 = float(datasets.logistic_loss(w, x0, y0))
    np.testing.assert_allclose(loss0, np.log(2.0), rtol=1e-6)
    err = float(datasets.incorrect(w, x0, y0))
    assert err in (0.0, 1.0)

  def test_libsvm_requires_data_dir(self):
    from precondition_tpu.oco import datasets

    name = next(n for n in datasets.SUPPORTED_DATASETS
                if not n.startswith("synthetic"))
    if datasets.DATA_DIR:
      pytest.skip("DATA_DIR configured in this environment")
    with pytest.raises(ValueError, match="DATA_DIR"):
      datasets._load_uncached(name)

  def test_libsvm_real_format_fixture(self, tmp_path):
    """The real sparse libsvm parse path, driven on a committed fixture.

    The fixture is an a9a-shaped file in genuine libsvm sparse format
    (123 binary features, ±1 labels — generated offline, zero-egress
    environment; see tests/data/libsvm/README).  The reference actually
    loads a9a/cifar10/gisette through the same svmlight parser
    (`/root/reference/precondition/oco/datasets.py:28-93`); until this
    fixture landed the parse path only ever ran on the dense synthetic
    fallback.
    """
    from precondition_tpu.oco import datasets

    fixture_dir = os.path.join(os.path.dirname(__file__), "data", "libsvm")
    old = datasets.DATA_DIR
    datasets.DATA_DIR = fixture_dir
    try:
      ds = datasets.load_dataset("a9a", cache=str(tmp_path / "cache"))
      dst = datasets.load_dataset("a9a.t", cache=str(tmp_path / "cache"))
    finally:
      datasets.DATA_DIR = old
    # a9a: 123 binary features; svmlight infers width from the max seen
    # index, +1 bias column appended by the loader.
    assert ds.x.shape[0] == 120 and dst.x.shape[0] == 40
    assert ds.x.shape[1] == ds.w_shape[0] <= 124
    assert ds.y.dtype == bool and 0 < ds.y.sum() < len(ds.y)
    # Sparse one-hot rows: every non-bias entry is 0/1.
    assert set(np.unique(ds.x)) == {0.0, 1.0}
    np.testing.assert_array_equal(ds.x[:, -1], 1.0)  # bias column

  def test_libsvm_fixture_end_to_end_train(self, tmp_path):
    """run_dataset on the real-format fixture: loss improves over OGD run."""
    from precondition_tpu.oco import algorithms, datasets, train

    fixture_dir = os.path.join(os.path.dirname(__file__), "data", "libsvm")
    old = datasets.DATA_DIR
    datasets.DATA_DIR = fixture_dir
    try:
      hp = algorithms.HParams(
          algorithm=algorithms.Algorithm.ADA, lr=0.5, delta=1e-8,
          sketch_size=0)
      hist = train.run_dataset(
          "a9a", num_obs=4, hparams=hp,
          dataset_cache=str(tmp_path / "cache"))
    finally:
      datasets.DATA_DIR = old
    losses = np.asarray(hist["loss"], dtype=np.float64)
    counts = np.asarray(hist["n"])
    assert counts[-1] == 120
    avg_first, avg_last = losses[1] / counts[1], losses[-1] / counts[-1]
    assert np.isfinite(avg_last)
    assert avg_last < avg_first  # online regret improves on real data


class _FakeSampler:
  """Deterministic 'model': returns canned token lists per prompt."""

  def __init__(self, generations):
    self.generations = generations

  def sample(self, prompts, max_new_tokens):
    return [self.generations[tuple(p)] for p in prompts]


class TestGenerationEval:

  def test_exact_match_scoring(self):
    from precondition_tpu.datamix.evals import generation_eval

    prompts = [[1], [2], [3]]
    gens = {(1,): [101], (2,): [102], (3,): [103]}
    texts = {101: "the answer is 42", 102: "= 7.", 103: "no digits here"}
    ev = generation_eval.GenerationEval(
        make_sampler=lambda params: _FakeSampler(gens),
        prompts=prompts, answers=["42", "8", "5"],
        detokenize=lambda toks: texts[toks[0]])
    assert ev.evaluate(params=None) == pytest.approx(1.0 / 3.0)

  def test_extract_last_number(self):
    from precondition_tpu.datamix.evals import generation_eval

    f = generation_eval.extract_last_number
    assert f("costs 1,234 dollars") == "1234"
    assert f("x = -3.5 then 7") == "7"
    assert f("nothing") is None


class TestCodeEval:

  def test_run_program_with_tests(self):
    from precondition_tpu.datamix.evals import code_eval

    good = "def add(a, b):\n  return a + b"
    assert code_eval.run_program_with_tests(good, ["assert add(1, 2) == 3"])
    assert not code_eval.run_program_with_tests(
        good, ["assert add(1, 2) == 4"])
    assert not code_eval.run_program_with_tests(
        "import time\ntime.sleep(30)", ["assert True"], timeout_s=1.0)

  def test_pass_rate(self):
    from precondition_tpu.datamix.evals import code_eval

    prompts = [[1], [2]]
    gens = {(1,): [1], (2,): [2]}
    programs = {1: "def f():\n  return 1", 2: "def f():\n  return 2"}
    ev = code_eval.CodeExecutionEval(
        make_sampler=lambda params: _FakeSampler(gens),
        prompts=prompts,
        tests=[["assert f() == 1"], ["assert f() == 1"]],
        detokenize=lambda toks: programs[toks[0]],
        timeout_s=10.0)
    assert ev.evaluate(params=None) == pytest.approx(0.5)


class TestTrajectoryPolicyArtifacts:
  """Committed trajectory-A/B artifacts must certify the shipped policies.

  The experiments themselves are too slow for CI
  (benchmarks/{tearfree_backend,pi_policy}_trajectory.py, ~7 min each);
  these tests pin their committed verdicts so a policy flip without a
  fresh passing artifact fails loudly.
  """

  def _load(self, name):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), name)
    if not os.path.exists(path):
      pytest.skip(f"{name} not present")
    import json
    with open(path) as f:
      return json.load(f)

  def test_filtered_backend_trajectory_within_noise(self):
    # The filtered backend is an accepted tearfree solver only while it
    # tracks eigh within seed noise.
    art = self._load("TEARFREE_BACKEND_TRAJ.json")
    assert art["verdict_filtered"] == "agree_within_noise", art[
        "gap_eigh_vs_filtered"]
    assert art["gap_eigh_vs_filtered"] <= 3.0 * art[
        "gap_seed_noise_filtered"]

  def test_loose_pi_policy_trajectory_within_noise(self):
    # The loose cold power-iteration exit (COLD_POWER_ITERATION_TOLERANCE)
    # must hold at the training level before any solve path adopts it.
    art = self._load("PI_POLICY_TRAJ.json")
    assert art["verdict"] == "agree_within_noise", art[
        "gap_tight_vs_loose"]
