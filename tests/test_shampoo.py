"""Distributed Shampoo tests.

Strategy (SURVEY.md §4): upstream-oracle parity on fixed fixtures across the
grafting/momentum/wd configuration grid, the reference's golden fixture
values, finiteness smoke, frequency-gating invariants, and multi-device
round-robin root distribution on a real 8-device CPU mesh.
"""

import functools

import chex
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from precondition_tpu.optim import shampoo

from conftest import requires_reference


def _fixture(seed=0):
  rng = np.random.RandomState(seed)
  params = {
      "w": jnp.asarray(rng.randn(4, 3) * 0.5, jnp.float32),
      "b": jnp.asarray(rng.randn(3) * 0.5, jnp.float32),
      "t": jnp.asarray(rng.randn(2, 3, 4) * 0.5, jnp.float32),
  }
  grads = [
      jax.tree.map(
          lambda p: jnp.asarray(rng.randn(*p.shape) * 0.1, jnp.float32),
          params) for _ in range(6)
  ]
  return params, grads


COMMON = dict(learning_rate=0.1, block_size=8, beta1=0.9, beta2=0.999,
              matrix_epsilon=1e-6, start_preconditioning_step=2)


def ref_ptype(name):
  from precondition import distributed_shampoo as ref
  return ref.PreconditionerType[name]


class TestShampoo:

  def test_finite_after_steps(self):
    params, grads = _fixture()
    tx = shampoo.distributed_shampoo(**COMMON)
    state = tx.init(params)
    update = jax.jit(tx.update)
    for g in grads:
      updates, state = update(g, state, params)
      params = jax.tree.map(lambda p, u: p + u, params, updates)
    chex.assert_tree_all_finite((params, state))

  def test_state_structure(self):
    params, _ = _fixture()
    tx = shampoo.distributed_shampoo(
        **COMMON, graft_type=shampoo.GraftingType.ADAGRAD)
    state = tx.init(params)
    w_stats = state.stats["w"]
    # [4,3] merges to [12] (product under merge threshold), then blocks to
    # [8, 4] with block_size 8: two 1-axis blocks -> two statistics.
    assert len(w_stats.statistics) == 2
    assert w_stats.statistics[0].shape == (8, 8)
    assert w_stats.statistics[1].shape == (4, 4)
    assert w_stats.diagonal_statistics.shape == (4, 3)
    # With merging off, [4,3] is one (uniform) block with two axes — the
    # stacked layout keeps one [nb, d, d] array per preconditioned axis.
    tx2 = shampoo.distributed_shampoo(
        **COMMON, best_effort_shape_interpretation=False)
    state2 = tx2.init(params)
    assert [s.shape for s in state2.stats["w"].statistics] == [
        (1, 4, 4), (1, 3, 3)]

  def test_blocking(self):
    params = {"w": jnp.zeros((10, 6))}
    tx = shampoo.distributed_shampoo(
        **{**COMMON, "block_size": 4}, best_effort_shape_interpretation=False)
    state = tx.init(params)
    # 10 -> [4,4,2] x 6 -> [4,2]: 6 blocks x 2 axes = 12 statistics
    # (ragged trailing blocks -> legacy per-block list layout).
    assert len(state.stats["w"].statistics) == 12
    # With merging on, [10,6] merges to [60] first: 15 uniform 1-axis
    # blocks -> ONE stacked [15, 4, 4] statistics array.
    tx_m = shampoo.distributed_shampoo(**{**COMMON, "block_size": 4})
    stats_m = tx_m.init(params).stats["w"].statistics
    assert len(stats_m) == 1 and stats_m[0].shape == (15, 4, 4)

  def test_preconditioning_compute_steps_gating(self):
    # With gating, preconditioners only refresh on multiples of k, but the
    # trajectory must stay finite and identical across two runs.
    params, grads = _fixture()
    tx = shampoo.distributed_shampoo(
        **COMMON, preconditioning_compute_steps=3, statistics_compute_steps=1)
    state = tx.init(params)
    update = jax.jit(tx.update)
    out = []
    for g in grads:
      updates, state = update(g, state, params)
      out.append(updates)
    chex.assert_tree_all_finite(out)

  @requires_reference
  @pytest.mark.parametrize("graft", ["sgd", "adagrad", "rmsprop", "sqrt_n",
                                     "none"])
  def test_matches_upstream_graft_types(self, graft):
    from precondition import distributed_shampoo as ref
    graft_ours = {
        "sgd": shampoo.GraftingType.SGD,
        "adagrad": shampoo.GraftingType.ADAGRAD,
        "rmsprop": shampoo.GraftingType.RMSPROP,
        "sqrt_n": shampoo.GraftingType.SQRT_N,
        "none": shampoo.GraftingType.NONE,
    }[graft]
    graft_ref = ref.GraftingType(int(graft_ours))
    self._compare_with_upstream(
        dict(graft_type=graft_ours), dict(graft_type=graft_ref))

  @requires_reference
  @pytest.mark.parametrize("kwargs", [
      dict(nesterov=False),
      dict(weight_decay=1e-3),
      dict(weight_decay=1e-3, decoupled_weight_decay=True),
      dict(decoupled_learning_rate=False),
      dict(moving_average_for_momentum=True),
      dict(beta2=1.0),
      dict(exponent_override=2),
      dict(preconditioning_compute_steps=2),
      dict(statistics_compute_steps=2),
      dict(best_effort_shape_interpretation=False),
      dict(eigh=True),
      dict(skip_preconditioning_dim_size_gt=3),
  ])
  def test_matches_upstream_options(self, kwargs):
    self._compare_with_upstream(kwargs, kwargs)

  @requires_reference
  def test_matches_upstream_one_sided_output(self):
    # merge_small_dims_block_size=8 keeps the fixture's 2-D params 2-D;
    # at the 4096 default they merge to rank 1, where one-sided modes
    # are (correctly, on both sides) ignored and the test proves nothing.
    self._compare_with_upstream(
        dict(precondtioner_type=shampoo.PreconditionerType.OUTPUT,
             merge_small_dims_block_size=8),
        dict(precondtioner_type=ref_ptype("OUTPUT"),
             merge_small_dims_block_size=8))

  @requires_reference
  @pytest.mark.parametrize("ptype", ["ALL", "INPUT", "OUTPUT"])
  def test_matches_upstream_one_sided_blocked(self, ptype):
    """One-sided preconditioning across a multi-block (uniform) parameter:
    exercises the stacked fast path's axis-cycling contraction, which the
    small unblocked fixture never reaches.  INPUT parity is possible here
    only because every param stays rank >= 2 unmerged — the reference's
    INPUT path crashes on any rank-1 (merged or vector) param, see
    `test_upstream_full_input_mode_is_broken`."""
    from precondition import distributed_shampoo as ref

    rng = np.random.RandomState(3)
    params = {"w": jnp.asarray(rng.randn(8, 4) * 0.5, jnp.float32)}
    grads = [jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape) * 0.1, jnp.float32),
        params) for _ in range(6)]
    kw = {**COMMON, "block_size": 2, "merge_small_dims_block_size": 8}
    ours_tx = shampoo.distributed_shampoo(
        **kw, precondtioner_type=shampoo.PreconditionerType[ptype])
    ref_tx = ref.distributed_shampoo(
        **kw, precondtioner_type=ref_ptype(ptype),
        generate_training_metrics=False)
    ours_state, ref_state = ours_tx.init(params), ref_tx.init(params)
    ours_params, ref_params = params, params
    for step, g in enumerate(grads):
      ours_up, ours_state = ours_tx.update(g, ours_state, ours_params)
      ref_up, ref_state = ref_tx.update(g, ref_state, ref_params)
      chex.assert_trees_all_close(
          ours_up, ref_up, rtol=2e-4, atol=1e-5,
          custom_message=f"step {step} ptype {ptype}")
      ours_params = jax.tree.map(lambda p, u: p + u, ours_params, ours_up)
      ref_params = jax.tree.map(lambda p, u: p + u, ref_params, ref_up)

  @requires_reference
  @pytest.mark.parametrize("ptype", ["INPUT", "OUTPUT"])
  @pytest.mark.parametrize("shape,bs", [((4, 3), 8), ((8, 4), 2),
                                        ((2, 3, 4), 8)])
  def test_one_sided_unit_parity(self, ptype, shape, bs):
    """Statistics + preconditioning parity with the reference's standalone
    `Preconditioner` for one-sided modes (blocked and unblocked).  The
    full-optimizer INPUT comparison is impossible upstream (see below),
    so the unit level is where INPUT semantics are pinned."""
    from precondition import distributed_shampoo as ref

    rng = np.random.RandomState(11)
    param = jnp.asarray(rng.randn(*shape), jnp.float32)
    g = jnp.asarray(rng.randn(*shape) * 0.1, jnp.float32)
    ours = shampoo.Preconditioner(
        param, bs, 8, True, shampoo.PreconditionerType[ptype])
    theirs = ref.Preconditioner(param, bs, 8, True, ref_ptype(ptype))
    assert (ours.shapes_for_preconditioners()
            == [list(map(int, s))
                for s in theirs.shapes_for_preconditioners()])
    assert (ours.exponent_for_preconditioner()
            == theirs.exponent_for_preconditioner())
    stats0 = [jnp.eye(int(s[0])) * 1e-6
              for s in ours.shapes_for_preconditioners()]
    ours_stats = ours.updated_statistics_from_grad(stats0, g, 0.9, 0.1)
    ref_stats = theirs.updated_statistics_from_grad(stats0, g, 0.9, 0.1)
    chex.assert_trees_all_close(ours_stats, ref_stats, rtol=1e-6, atol=1e-7)
    pres = [jnp.asarray(
        np.linalg.inv(np.asarray(s) + 1e-4 * np.eye(s.shape[0])),
        jnp.float32) for s in ours_stats]
    ours_pg = ours.preconditioned_grad(g, pres)
    ref_pg = theirs.preconditioned_grad(g, pres)
    chex.assert_trees_all_close(ours_pg, ref_pg, rtol=1e-5, atol=1e-6)

  @requires_reference
  def test_upstream_full_input_mode_is_broken(self):
    """Tripwire: the reference's full optimizer crashes in INPUT mode
    (`_preconds_for_grad` assert, `distributed_shampoo.py:1621` — its
    per-param preconditioner packing mishandles one-sided counts; the
    mode has zero upstream tests).  Our INPUT mode works (unit parity
    above + trajectory sanity below); if upstream ever fixes theirs,
    this test fails and the full-trajectory comparison should be added."""
    from precondition import distributed_shampoo as ref

    params = {"w": jnp.zeros((4, 3), jnp.float32)}
    g = {"w": jnp.full((4, 3), 0.1, jnp.float32)}
    tx = ref.distributed_shampoo(
        **COMMON, precondtioner_type=ref_ptype("INPUT"),
        generate_training_metrics=False)
    state = tx.init(params)
    with pytest.raises(AssertionError):
      tx.update(g, state, params)

  def test_input_mode_trajectory_sane(self):
    """Our INPUT mode end-to-end: finite, converging, and actually
    one-sided (output-axis statistics never allocated)."""
    rng = np.random.RandomState(5)
    params = {"w": jnp.asarray(rng.randn(8, 4) * 0.5, jnp.float32)}
    tx = shampoo.distributed_shampoo(
        **{**COMMON, "block_size": 2, "merge_small_dims_block_size": 8},
        precondtioner_type=shampoo.PreconditionerType.INPUT)
    state = tx.init(params)
    # 8x4 at block 2 -> 8 blocks, ONE [2,2] statistic each (input side);
    # uniform blocks -> one stacked [8, 2, 2] array for the single slot.
    w_stats = state.stats["w"].statistics
    assert len(w_stats) == 1 and w_stats[0].shape == (8, 2, 2)
    p = params
    for i in range(6):
      g = jax.tree.map(
          lambda x: jnp.asarray(rng.randn(*x.shape) * 0.1, jnp.float32), p)
      up, state = tx.update(g, state, p)
      p = jax.tree.map(lambda a, b: a + b, p, up)
    chex.assert_tree_all_finite(p)

  @requires_reference
  def test_matches_upstream_reuse_preconditioner(self):
    # The reference accepts reuse_preconditioner but discards the plumbed
    # prev (`distributed_shampoo.py:764`); ours actually warm-starts, so
    # parity holds at the solver tolerance rather than bit-tight.
    self._compare_with_upstream(
        dict(reuse_preconditioner=True), dict(reuse_preconditioner=True),
        rtol=2e-3, atol=2e-4)

  def test_reuse_preconditioner_matches_cold(self):
    # Warm-started roots must reproduce the cold trajectory within the
    # solver tolerance on every step.
    params, grads = _fixture()
    warm_tx = shampoo.distributed_shampoo(**COMMON,
                                          reuse_preconditioner=True)
    cold_tx = shampoo.distributed_shampoo(**COMMON)
    warm_state, cold_state = warm_tx.init(params), cold_tx.init(params)
    warm_params, cold_params = params, params
    for step, g in enumerate(grads):
      warm_up, warm_state = warm_tx.update(g, warm_state, warm_params)
      cold_up, cold_state = cold_tx.update(g, cold_state, cold_params)
      chex.assert_trees_all_close(
          warm_up, cold_up, rtol=2e-3, atol=2e-4,
          custom_message=f"step {step}")
      warm_params = jax.tree.map(lambda p, u: p + u, warm_params, warm_up)
      cold_params = jax.tree.map(lambda p, u: p + u, cold_params, cold_up)
    # And the warm path's roots must be accepted (no failure fallback):
    errors = warm_state.stats["w"].training_metrics.error
    assert float(jnp.max(errors)) < 0.1

  @requires_reference
  @pytest.mark.parametrize("kwargs", [
      dict(compression_rank=1),
      dict(compression_rank=-1),
      # Upstream's FD path requires reuse_preconditioner to plumb `prev`.
      dict(compression_rank=1, frequent_directions=True,
           reuse_preconditioner=True),
      # Windowed-FD restart: beta2=0.75 -> reset every 4 steps, so the
      # zeroing fires inside the 6-step comparison window.
      dict(compression_rank=1, frequent_directions=True,
           reuse_preconditioner=True, reset_preconditioner=True,
           beta2=0.75),
  ])
  def test_matches_upstream_compression(self, kwargs):
    # The larger fixture gives dims where rank+2 < d so compression kicks
    # in (merged [4,3]->12 and [2,3,4]->24 blocks of 8).
    self._compare_with_upstream(kwargs, kwargs, rtol=5e-3, atol=5e-4)

  @requires_reference
  def test_matches_upstream_quantized(self):
    # Both sides quantize statistics to int16 (+diagonal) and momenta to
    # int8; quantisation noise needs loose tolerances.
    self._compare_with_upstream(
        dict(best_effort_memory_usage_reduction=True),
        dict(best_effort_memory_usage_reduction=True),
        rtol=5e-2, atol=5e-3)

  def test_quantized_momentum_close_to_unquantized(self):
    params, grads = _fixture()
    tx_q = shampoo.distributed_shampoo(
        **COMMON, best_effort_memory_usage_reduction=True)
    tx_f = shampoo.distributed_shampoo(**COMMON)
    s_q, s_f = tx_q.init(params), tx_f.init(params)
    from precondition_tpu.utils.quantization import QuantizedValue
    assert isinstance(s_q.stats["w"].momentum, QuantizedValue)
    assert s_q.stats["w"].momentum.quantized.dtype == jnp.int8
    for step, g in enumerate(grads[:4]):
      u_q, s_q = tx_q.update(g, s_q, params)
      u_f, s_f = tx_f.update(g, s_f, params)
      chex.assert_trees_all_close(u_q, u_f, rtol=0.1, atol=5e-3,
                                  custom_message=f"step {step}")

  def _compare_with_upstream(self, ours_kwargs, ref_kwargs, steps=6,
                             rtol=2e-4, atol=1e-5):
    from precondition import distributed_shampoo as ref
    params, grads = _fixture()
    ours_tx = shampoo.distributed_shampoo(**{**COMMON, **ours_kwargs})
    ref_tx = ref.distributed_shampoo(
        **{**COMMON, **ref_kwargs}, generate_training_metrics=False)
    ours_state = ours_tx.init(params)
    ref_state = ref_tx.init(params)
    ours_params, ref_params = params, params
    for step, g in enumerate(grads[:steps]):
      ours_up, ours_state = ours_tx.update(g, ours_state, ours_params)
      ref_up, ref_state = ref_tx.update(g, ref_state, ref_params)
      # atol floor covers f32 roundoff from the differing (but equally
      # valid) power-iteration start vectors feeding the relative ridge,
      # and from the statically-unrolled mat_power's matmul ordering.
      chex.assert_trees_all_close(
          ours_up, ref_up, rtol=rtol, atol=atol,
          custom_message=f"step {step} kwargs {ours_kwargs}")
      ours_params = jax.tree.map(lambda p, u: p + u, ours_params, ours_up)
      ref_params = jax.tree.map(lambda p, u: p + u, ref_params, ref_up)


class TestGolden:
  """The reference test-suite's golden fixture values.

  `distributed_shampoo_test.py:90-258`: with the reference's default hypers
  (lr 0.1, SGD grafting, Nesterov, decoupled lr, start_preconditioning_step
  5), the step-0 update is the grafted SGD + Nesterov step
  ``-lr * (1 + beta1) * g = -0.19 g``; the asserted entry (g = 3.0) gives
  exactly -0.57 +- 1e-4.
  """

  def test_first_step_update(self):
    params = (jnp.asarray([[1., 3.], [2., 4.]]),
              jnp.asarray([[3., 4.], [3., 4.]]))
    grads = (jnp.asarray([[500., 5.], [500., 5.]]),
             jnp.asarray([[300., 3.], [300., 3.]]))
    tx = shampoo.distributed_shampoo(0.1, 32, preconditioning_compute_steps=2)
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    assert abs(float(updates[1][-1, -1]) - (-0.57)) < 1e-4, updates[1]
    # And the trajectory stays finite over further steps.
    for _ in range(5):
      updates, state = tx.update(grads, state, params)
    chex.assert_tree_all_finite((updates, state))

  @staticmethod
  def _larger_fixture():
    """The reference's "slightly larger" fixture
    (`distributed_shampoo_test.py:102-114`): seeded standard-normal
    params/updates with a 100x first column in the updates."""
    rng = np.random.default_rng(1234)
    shape = ([2, 5], [6, 3])

    def make(bigger_first_entry):
      x = tuple(rng.standard_normal(size=s) for s in shape)
      if bigger_first_entry:
        for xx in x:
          xx[..., 0] *= 100
      return tuple(jnp.asarray(xx, jnp.float32) for xx in x)

    params = make(False)
    grads = make(True)
    return params, grads

  @pytest.mark.parametrize("kwargs", [
      dict(best_effort_memory_usage_reduction=True),
      dict(best_effort_memory_usage_reduction=True,
           merge_small_dims_block_size=1),
      dict(compression_rank=1),
      dict(compression_rank=1, merge_small_dims_block_size=1),
      dict(compression_rank=-1),
      dict(compression_rank=-1, merge_small_dims_block_size=1),
      dict(best_effort_memory_usage_reduction=True,
           reuse_preconditioner=True),
      dict(reuse_preconditioner=True),
      dict(reuse_preconditioner=True, merge_small_dims_block_size=1),
  ])
  def test_larger_fixture_golden(self, kwargs):
    """The -0.17019942 golden family (`distributed_shampoo_test.py:
    133-209`): the step-0 update entry must hit the golden across the
    quantized/compressed/merged/warm-started state layouts, and the
    trajectory must stay finite thereafter."""
    params, grads = self._larger_fixture()
    tx = shampoo.distributed_shampoo(
        0.1, 32, preconditioning_compute_steps=2, **kwargs)
    state = tx.init(params)
    update = jax.jit(tx.update)
    updates, state = update(grads, state, params)
    got = float(updates[1][-1, -1])
    assert abs(got - (-0.17019942)) < 1e-4, got
    for _ in range(5):
      updates, state = update(grads, state, params)
    chex.assert_tree_all_finite((updates, state))


class TestShardedMode:
  """Memory-sharded (pjit-equivalent) mode."""

  def test_init_fns_contract(self):
    params = {"w": jnp.zeros((6, 4)), "b": jnp.zeros((4,))}
    tx = shampoo.distributed_shampoo(
        **COMMON, shard_optimizer_states=True, num_devices_for_pjit=4)
    fns = tx.init(None)
    state = fns.init_fn(params)
    gs = state.stats.global_stats
    # [6,4] merges to [24] -> one 8-block + one 8-block + one 8-block? No:
    # 24 with block 8 -> 3 blocks of [8,8]; padded to multiple of 4 -> 4.
    assert gs.statistics.shape[0] % 4 == 0
    assert gs.statistics.shape[1] == gs.statistics.shape[2]
    shapes = fns.shape_and_dtype_fn(params)
    assert (shapes.stats.global_stats.statistics[0]
            == list(gs.statistics.shape))
    specs = fns.pspec_fn(params)
    assert specs.count is not None

  @requires_reference
  def test_matches_upstream_pjit_mode(self):
    from precondition import distributed_shampoo as ref
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    rng = np.random.RandomState(0)
    params = {"w": jnp.asarray(rng.randn(4, 3) * 0.5, jnp.float32),
              "t": jnp.asarray(rng.randn(2, 3, 4) * 0.5, jnp.float32)}
    grads = [jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape) * 0.1, jnp.float32),
        params) for _ in range(5)]

    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    repl = NamedSharding(mesh, P())
    kw = dict(learning_rate=0.1, block_size=8, start_preconditioning_step=2,
              shard_optimizer_states=True, num_devices_for_pjit=1)
    ours_tx = shampoo.distributed_shampoo(
        **kw, statistics_partition_spec=repl,
        preconditioner_partition_spec=repl,
        graft_type=shampoo.GraftingType.RMSPROP)
    ref_tx = ref.distributed_shampoo(
        **kw, statistics_partition_spec=P(),
        preconditioner_partition_spec=P(),
        graft_type=ref.GraftingType.RMSPROP,
        generate_training_metrics=False)
    with jax.sharding.set_mesh(mesh):
      ours_s = ours_tx.init(None).init_fn(params)
      ref_s = ref_tx.init(None).init_fn(params)
      for step, g in enumerate(grads):
        ours_u, ours_s = ours_tx.update(g, ours_s, params)
        ref_u, ref_s = ref_tx.update(g, ref_s, params)
        chex.assert_trees_all_close(
            ours_u, ref_u, rtol=2e-4, atol=5e-5,
            custom_message=f"step {step}")

  def test_delayed_preconditioning_lags_one_solve(self):
    """delayed_preconditioning solves from the carried statistics: the
    preconditioners after step t must equal the synchronous mode's after
    step t-1 (same stats stream), making the solve independent of the
    step's incoming gradients (the overlap-with-compute contract)."""
    params, grads = _fixture()
    delayed_tx = shampoo.distributed_shampoo(
        **COMMON, delayed_preconditioning=True)
    cold_tx = shampoo.distributed_shampoo(**COMMON)
    d_state, c_state = delayed_tx.init(params), cold_tx.init(params)
    d_upd = jax.jit(delayed_tx.update)
    c_upd = jax.jit(cold_tx.update)
    c_pre_history = []
    for step, g in enumerate(grads):
      # Identical gradient streams; params only provide shape metadata to
      # the solve, so the preconditioner sequences must align exactly.
      d_up, d_state = d_upd(g, d_state, params)
      c_up, c_state = c_upd(g, c_state, params)
      c_pre_history.append(
          [np.asarray(p) for p in c_state.stats["w"].preconditioners])
      if step >= 1:
        got = [np.asarray(p) for p in d_state.stats["w"].preconditioners]
        want = c_pre_history[step - 1]
        for a, b in zip(got, want):
          np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
      chex.assert_tree_all_finite((d_up, d_state))

  def test_delayed_composes_with_reuse_and_quantized(self):
    """delayed + warm-started solves + int8/int16 state run together (the
    production steady-state combination) and track the plain delayed
    trajectory within warm-start tolerance."""
    params, grads = _fixture()
    ref_tx = shampoo.distributed_shampoo(
        **COMMON, delayed_preconditioning=True)
    tx = shampoo.distributed_shampoo(
        **COMMON, delayed_preconditioning=True, reuse_preconditioner=True,
        best_effort_memory_usage_reduction=True)
    ref_state, state = ref_tx.init(params), tx.init(params)
    ref_upd, upd = jax.jit(ref_tx.update), jax.jit(tx.update)
    for g in grads:
      ref_u, ref_state = ref_upd(g, ref_state, params)
      u, state = upd(g, state, params)
      chex.assert_tree_all_finite((u, state))
    # int16 statistics + warm starts perturb the roots slightly; the
    # final update direction must still match closely.
    for key in ("w", "t"):
      np.testing.assert_allclose(
          np.asarray(u[key]), np.asarray(ref_u[key]), rtol=5e-2, atol=5e-3)

  def test_delayed_rejects_fd(self):
    with pytest.raises(ValueError):
      shampoo.distributed_shampoo(
          **COMMON, delayed_preconditioning=True, compression_rank=2,
          frequent_directions=True, reuse_preconditioner=True)

  def test_reset_preconditioner_requires_fd(self):
    with pytest.raises(ValueError):
      shampoo.distributed_shampoo(**COMMON, reset_preconditioner=True)

  def test_matches_delayed_default_mode_on_four_devices(self):
    """ZeRO mode transforms with the roots carried from the previous step,
    which is the default mode's ``delayed_preconditioning``: the two agree
    to float32 rounding.  The tree mixes params read as whole chunks of the
    global stack ("w", "b") with per-slot ones (the ragged "v", the merged
    rank-3 "t")."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    rng = np.random.RandomState(0)
    params = {"w": jnp.asarray(rng.randn(16, 24) * 0.5, jnp.float32),
              "v": jnp.asarray(rng.randn(12, 8) * 0.5, jnp.float32),
              "t": jnp.asarray(rng.randn(2, 3, 4) * 0.5, jnp.float32),
              "b": jnp.asarray(rng.randn(16) * 0.5, jnp.float32)}
    grads = [jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape) * 0.1, jnp.float32),
        params) for _ in range(5)]
    mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
    spec = NamedSharding(mesh, P("d"))
    kw = dict(learning_rate=0.1, block_size=8, start_preconditioning_step=2,
              graft_type=shampoo.GraftingType.RMSPROP,
              generate_training_metrics=False)
    zero_tx = shampoo.distributed_shampoo(
        **kw, shard_optimizer_states=True, num_devices_for_pjit=4,
        statistics_partition_spec=spec, preconditioner_partition_spec=spec)
    delayed_tx = shampoo.distributed_shampoo(
        **kw, delayed_preconditioning=True)
    zero_s = jax.jit(zero_tx.init(None).init_fn)(params)
    delayed_s = delayed_tx.init(params)
    zero_update, delayed_update = jax.jit(zero_tx.update), jax.jit(
        delayed_tx.update)
    for step, g in enumerate(grads):
      zero_u, zero_s = zero_update(g, zero_s, params)
      delayed_u, delayed_s = delayed_update(g, delayed_s, params)
      chex.assert_trees_all_close(zero_u, delayed_u, rtol=1e-5, atol=1e-5,
                                  custom_message=f"step {step}")

  def test_sharded_reuse_preconditioner_matches_cold(self):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    rng = np.random.RandomState(0)
    params = {"w": jnp.asarray(rng.randn(4, 3) * 0.5, jnp.float32),
              "t": jnp.asarray(rng.randn(2, 3, 4) * 0.5, jnp.float32)}
    grads = [jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape) * 0.1, jnp.float32),
        params) for _ in range(5)]
    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    repl = NamedSharding(mesh, P())
    kw = dict(learning_rate=0.1, block_size=8, start_preconditioning_step=2,
              shard_optimizer_states=True, num_devices_for_pjit=1,
              statistics_partition_spec=repl,
              preconditioner_partition_spec=repl,
              graft_type=shampoo.GraftingType.RMSPROP)
    warm_tx = shampoo.distributed_shampoo(**kw, reuse_preconditioner=True)
    cold_tx = shampoo.distributed_shampoo(**kw)
    with jax.sharding.set_mesh(mesh):
      warm_s = warm_tx.init(None).init_fn(params)
      cold_s = cold_tx.init(None).init_fn(params)
      for step, g in enumerate(grads):
        warm_u, warm_s = warm_tx.update(g, warm_s, params)
        cold_u, cold_s = cold_tx.update(g, cold_s, params)
        chex.assert_trees_all_close(
            warm_u, cold_u, rtol=2e-3, atol=2e-4,
            custom_message=f"step {step}")


class TestMultiDevice:
  """Root-solve distribution across a real 8-device CPU mesh."""

  def test_pmap_round_robin_matches_single(self):
    n_dev = jax.local_device_count()
    assert n_dev >= 2, "conftest should force 8 CPU devices"

    params, grads = _fixture()
    single_tx = shampoo.distributed_shampoo(**COMMON)
    multi_tx = shampoo.distributed_shampoo(**COMMON, batch_axis_name="batch")

    # Single-device trajectory.
    s_state = single_tx.init(params)
    s_updates = []
    for g in grads:
      u, s_state = jax.jit(single_tx.update)(g, s_state, params)
      s_updates.append(u)

    # pmapped trajectory with identical replicated inputs.
    rep = lambda tree: jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_dev,) + x.shape), tree)
    m_state = jax.pmap(multi_tx.init, axis_name="batch")(rep(params))
    p_update = jax.pmap(multi_tx.update, axis_name="batch")
    for step, g in enumerate(grads):
      m_up, m_state = p_update(rep(g), m_state, rep(params))
      chex.assert_trees_all_close(
          jax.tree.map(lambda x: x[0], m_up), s_updates[step],
          rtol=2e-4, atol=1e-6, custom_message=f"step {step}")

  @pytest.mark.parametrize("fd", [False, True])
  def test_pmap_compressed_round_robin_matches_single(self, fd):
    """Low-rank/FD groups must distribute like full ones: the pmapped
    trajectory (each replica solving its slice of the compressed batch,
    all-gathering results) must match the single-device run.  Reference
    semantics: everything round-robins, `distributed_shampoo.py:2732-2744,
    2862-2892`."""
    n_dev = jax.local_device_count()
    assert n_dev >= 2

    rng = np.random.RandomState(3)
    params = {"w": jnp.asarray(rng.randn(64, 64) * 0.3, jnp.float32)}
    grads = [jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape) * 0.1, jnp.float32),
        params) for _ in range(4)]
    kw = dict(learning_rate=0.1, block_size=32, start_preconditioning_step=0,
              compression_rank=4, frequent_directions=fd,
              graft_type=shampoo.GraftingType.RMSPROP)
    single_tx = shampoo.distributed_shampoo(**kw)
    multi_tx = shampoo.distributed_shampoo(**kw, batch_axis_name="batch")

    s_state = single_tx.init(params)
    s_updates = []
    for g in grads:
      u, s_state = jax.jit(single_tx.update)(g, s_state, params)
      s_updates.append(u)

    rep = lambda tree: jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_dev,) + x.shape), tree)
    m_state = jax.pmap(multi_tx.init, axis_name="batch")(rep(params))
    p_update = jax.pmap(multi_tx.update, axis_name="batch")
    for step, g in enumerate(grads):
      m_up, m_state = p_update(rep(g), m_state, rep(params))
      chex.assert_trees_all_close(
          jax.tree.map(lambda x: x[0], m_up), s_updates[step],
          rtol=2e-4, atol=1e-6, custom_message=f"step {step} fd={fd}")

  @pytest.mark.parametrize("fd", [False, True])
  def test_compressed_solve_work_scales_inverse_n(self, fd):
    """Per-device solve work for compressed (low-rank/FD) groups must
    scale ~1/N across the shard_map mesh.

    Asserted structurally on the per-device compiled HLO rather than
    `cost_analysis()["flops"]`: on CPU the eigensolves lower to LAPACK
    custom calls whose FLOPs the cost model does not count, but the
    batched decomposition's leading dimension IS each device's share of
    the solve batch.  The fixture's 64x64 param merges to [4096] and
    blocks into 128 [32,32] statistics, so the per-device eigh (lowrank)
    / SVD (fd) batch must be exactly 128/k."""
    import re
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    rng = np.random.RandomState(4)
    params = {"w": jnp.asarray(rng.randn(64, 64) * 0.3, jnp.float32)}
    grad = jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape) * 0.1, jnp.float32),
        params)
    target = "lapack_sgesdd" if fd else "lapack_ssyevd"

    def _solve_batch_dim(txt):
      dims = []
      for line in txt.splitlines():
        if "custom-call" in line and target in line:
          m = re.search(r"f32\[(\d+),32,\d+\]", line)
          if m:
            dims.append(int(m.group(1)))
      assert dims, f"no batched {target} decomposition in the HLO"
      return max(dims)

    for k in (1, 2, 8):
      mesh = Mesh(np.asarray(jax.devices()[:k]).reshape(k), ("d",))
      sh = NamedSharding(mesh, P("d"))
      tx = shampoo.distributed_shampoo(
          learning_rate=0.1, block_size=32, start_preconditioning_step=0,
          compression_rank=4, frequent_directions=fd,
          statistics_partition_spec=sh, preconditioner_partition_spec=sh,
          graft_type=shampoo.GraftingType.RMSPROP)
      state = tx.init(params)
      txt = jax.jit(tx.update).lower(grad, state, params).compile().as_text()
      assert _solve_batch_dim(txt) == 128 // k, (k, fd)

  @pytest.mark.parametrize("pad_devices", [8, None])
  def test_sharded_solve_no_full_rematerialization(self, capfd, pad_devices):
    """The shard_map solve must compile without SPMD falling back to
    "Involuntary full rematerialization" (replicate-then-reshard) when
    distributing the per-statistic roots — the silent perf cliff the
    round-1 with_sharding_constraint formulation hit. With
    ``pad_devices=None`` the padding multiple must be inferred from the
    NamedSharding's mesh (unset num_devices_for_pjit used to fall back to
    the resharding path on uneven batch counts)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    n_dev = jax.local_device_count()
    assert n_dev >= 8
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("data", "model"))
    solve_sharding = NamedSharding(mesh, P(("data", "model")))

    params, grads = _fixture()
    tx = shampoo.distributed_shampoo(
        **COMMON,
        statistics_partition_spec=solve_sharding,
        preconditioner_partition_spec=solve_sharding,
        num_devices_for_pjit=pad_devices)
    state = tx.init(params)
    capfd.readouterr()  # drop anything emitted before the compile
    compiled = jax.jit(tx.update).lower(grads[0], state, params).compile()
    err = capfd.readouterr().err
    assert "Involuntary full rematerialization" not in err, err

    # And the sharded trajectory matches the plain single-device one.
    single_tx = shampoo.distributed_shampoo(**COMMON)
    s_state = single_tx.init(params)
    p, sp = params, params
    for step, g in enumerate(grads):
      u, state = compiled(g, state, p)
      su, s_state = jax.jit(single_tx.update)(g, s_state, sp)
      chex.assert_trees_all_close(
          u, su, rtol=2e-4, atol=1e-6, custom_message=f"step {step}")
      p = jax.tree.map(lambda a, b: a + b, p, u)
      sp = jax.tree.map(lambda a, b: a + b, sp, su)
