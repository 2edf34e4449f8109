"""Tearfree stack tests: invariance oracles, analytic roots, upstream parity."""

import dataclasses

import chex
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from precondition_tpu.tearfree import grafting
from precondition_tpu.tearfree import momentum
from precondition_tpu.tearfree import optimizer
from precondition_tpu.tearfree import reshaper
from precondition_tpu.tearfree import second_order
from precondition_tpu.tearfree import shampoo
from precondition_tpu.tearfree import sketchy

from conftest import requires_reference


class TestBlockify:

  @pytest.mark.parametrize("shape,bs", [
      ((3, 2), 5),          # no large axes
      ((5, 2), 5),          # one large axis at 0
      ((2, 10), 5),         # one large axis at 1
      ((15, 2, 10), 5),     # two large axes split by a middle
      ((3, 20, 25, 4), 5),  # two adjacent large axes
      ((10, 10), 5),
      ((5,), 5),
  ])
  def test_roundtrip(self, shape, bs):
    opts = shampoo.Options(block_size=bs)
    meta = shampoo._blocks_meta(opts, shape)
    x = jnp.arange(np.prod(shape), dtype=jnp.float32).reshape(shape)
    blocked = shampoo._blockify(x, meta)
    assert blocked.shape[meta.blocks_axis] == meta.num_blocks
    np.testing.assert_array_equal(shampoo._deblockify(blocked, meta), x)

  def test_block_content(self):
    # [4, 2] with block 2: two blocks stacked along axis 0.
    opts = shampoo.Options(block_size=2)
    meta = shampoo._blocks_meta(opts, (4, 2))
    x = jnp.arange(8.0).reshape(4, 2)
    blocked = shampoo._blockify(x, meta)
    assert blocked.shape == (2, 2, 2)
    np.testing.assert_array_equal(blocked[0], x[:2])
    np.testing.assert_array_equal(blocked[1], x[2:])


class TestShampooAnalytic:

  def test_2d_analytic_root(self):
    """One step at full stats: update must equal L^-1/4 G R^-1/4."""
    rng = np.random.RandomState(0)
    g = jnp.asarray(rng.randn(3, 4), jnp.float32)
    opts = shampoo.Options(block_size=8, second_moment_decay=1.0)
    tx = shampoo.apply(opts)
    state = tx.init({"w": g})
    out, _ = tx.update({"w": g}, state, {"w": g})

    left = np.asarray(g) @ np.asarray(g).T
    right = np.asarray(g).T @ np.asarray(g)

    def inv_root(m, p):
      w, v = np.linalg.eigh(m)
      mask = w <= 1e-6 * w.max()
      w_inv = np.where(mask, 0.0, np.where(mask, 1.0, w) ** (-1.0 / p))
      return (v * w_inv) @ v.T

    want = inv_root(left, 4) @ np.asarray(g) @ inv_root(right, 4)
    # The right factor of a single [3,4] gradient is rank-3-of-4; f32 eigh
    # eigenvector error around the null direction costs ~1% here.
    np.testing.assert_allclose(out["w"], want, rtol=2e-2, atol=1e-4)

  def test_1d(self):
    g = jnp.asarray([1.0, 2.0, 2.0])
    opts = shampoo.Options(block_size=8, second_moment_decay=1.0)
    tx = shampoo.apply(opts)
    state = tx.init({"w": g})
    out, _ = tx.update({"w": g}, state, {"w": g})
    # Stats = g g^T (rank 1); root^2 pseudo-inverts: P g = g / |g|.
    want = np.asarray(g) / np.linalg.norm(g)
    np.testing.assert_allclose(out["w"], want, rtol=1e-3, atol=1e-4)

  def test_blocked_equals_unblocked_per_block(self):
    """Blocked run == separate runs on each block (invariance oracle)."""
    rng = np.random.RandomState(1)
    g = jnp.asarray(rng.randn(4, 2), jnp.float32)
    opts = shampoo.Options(block_size=2, second_moment_decay=0.9)
    tx = shampoo.apply(opts)
    state = tx.init({"w": g})
    out, _ = tx.update({"w": g}, state, {"w": g})

    opts_big = shampoo.Options(block_size=8, second_moment_decay=0.9)
    tx_big = shampoo.apply(opts_big)
    for i in range(2):
      blk = g[2 * i:2 * i + 2]
      s = tx_big.init({"w": blk})
      ob, _ = tx_big.update({"w": blk}, s, {"w": blk})
      np.testing.assert_allclose(out["w"][2 * i:2 * i + 2], ob["w"],
                                 rtol=1e-3, atol=1e-4)

  def test_validation(self):
    with pytest.raises(ValueError):
      shampoo.apply(shampoo.Options(block_size=1))
    with pytest.raises(ValueError):
      shampoo.apply(shampoo.Options(update_statistics_freq=0))
    with pytest.raises(ValueError):
      shampoo.apply(shampoo.Options(second_moment_decay=1.5))
    tx = shampoo.apply(shampoo.Options(block_size=4))
    with pytest.raises(ValueError, match="unit dim"):
      tx.init({"w": jnp.zeros((3, 1))})
    with pytest.raises(ValueError, match="indivisible"):
      tx.init({"w": jnp.zeros((6, 3))})
    with pytest.raises(ValueError, match="large dims"):
      tx.init({"w": jnp.zeros((4, 4, 4))})



class TestNewtonSolverBackend:
  """Opt-in coupled-Newton roots for the blocked-Shampoo layer."""

  def test_newton_matches_eigh_on_full_rank_stats(self):
    # Where the spectrum is numerically full rank the ridge (newton) and
    # zero-clip (eigh) semantics coincide to solver tolerance.
    rng = np.random.RandomState(5)
    g = rng.randn(6, 16, 16).astype(np.float32)
    cov = jnp.einsum("nij,nkj->nik", g, g) / 16 + 0.05 * jnp.eye(16)[None]
    for p in (2, 4):
      eigh_roots = shampoo._pth_inv_root(p, cov)
      newton_roots = shampoo._newton_inv_root(p, cov)
      np.testing.assert_allclose(eigh_roots, newton_roots,
                                 rtol=5e-3, atol=5e-4)

  def test_newton_trajectory_finite_and_close(self):
    rng = np.random.RandomState(6)
    params = {"w": jnp.asarray(rng.randn(8, 8) * 0.3, jnp.float32)}
    kw = dict(block_size=8, second_moment_decay=0.9)
    tx_e = shampoo.apply(shampoo.Options(**kw))
    tx_n = shampoo.apply(shampoo.Options(**kw, solver_backend="newton"))
    se, sn = tx_e.init(params), tx_n.init(params)
    for i in range(6):
      g = {"w": jnp.asarray(rng.randn(8, 8) * 0.1, jnp.float32)}
      ue, se = tx_e.update(g, se, params)
      un, sn = tx_n.update(g, sn, params)
      chex.assert_tree_all_finite(un)
      if i >= 3:  # once stats accumulate toward full rank, they agree
        chex.assert_trees_all_close(ue, un, rtol=0.1, atol=5e-3)

  def test_validation(self):
    with pytest.raises(ValueError, match="solver_backend"):
      shampoo.apply(shampoo.Options(solver_backend="nope"))


class TestFilteredSolverBackend:
  """The eigh-null-space-semantics fast root (projector x Newton)."""

  def test_filtered_matches_eigh_on_rank_deficient_stats(self):
    # THE distinguishing case: rank-deficient covariances, where the plain
    # ridge (newton) root blows null directions up by ~eps^{-1/p} while
    # eigh zero-clips them.  The filtered backend must stay on eigh's side.
    rng = np.random.RandomState(7)
    d, n = 32, 6
    mats = []
    for _ in range(n):
      u = np.linalg.qr(rng.randn(d, d))[0].astype(np.float32)
      w = np.zeros(d, np.float32)
      w[:12] = np.exp(rng.rand(12) * 4).astype(np.float32)
      mats.append(u @ np.diag(w) @ u.T)
    cov = jnp.asarray(np.stack(mats))
    for p in (2, 4):
      eigh_roots = np.asarray(shampoo._pth_inv_root(p, cov))
      filt_roots = np.asarray(shampoo._filtered_inv_root(p, cov))
      newton_roots = np.asarray(shampoo._newton_inv_root(p, cov))
      scale = np.max(np.abs(eigh_roots))
      # Filtered tracks eigh to a few percent (the kept modes' ridge
      # shift); the plain ridge root does not even come close.
      assert np.max(np.abs(eigh_roots - filt_roots)) < 0.05 * scale
      assert np.max(np.abs(eigh_roots - newton_roots)) > 2.0 * scale

  def test_filtered_tiny_early_training_covariances(self):
    """Regression: lambda_max << 1 rank-deficient stats (the state a few
    steps into training).  A loose power-iteration estimate used as the
    sign-iteration scale diverged here (spectrum >> 1 -> NaN within ~5
    iterations); the norm-bound scaling must stay finite and on eigh."""
    rng = np.random.RandomState(9)
    d, n = 64, 4
    mats = []
    for _ in range(n):
      u = np.linalg.qr(rng.randn(d, d))[0].astype(np.float32)
      w = np.zeros(d, np.float32)
      w[:5] = 1e-7 * np.exp(rng.rand(5) * 2).astype(np.float32)
      mats.append(u @ np.diag(w) @ u.T)
    cov = jnp.asarray(np.stack(mats))
    eigh_roots = np.asarray(shampoo._pth_inv_root(4, cov))
    filt_roots = np.asarray(shampoo._filtered_inv_root(4, cov))
    assert np.isfinite(filt_roots).all()
    scale = np.max(np.abs(eigh_roots))
    assert np.max(np.abs(eigh_roots - filt_roots)) < 0.05 * scale

  def test_filtered_zero_covariance_zero_root(self):
    # Step-0 state: eigh masks everything on a zero covariance; the
    # filtered backend must match (not emit the huge tiny-ridge root).
    z = jnp.zeros((2, 8, 8), jnp.float32)
    assert float(jnp.max(jnp.abs(shampoo._filtered_inv_root(4, z)))) == 0.0

  def test_filtered_trajectory_tracks_eigh(self):
    rng = np.random.RandomState(8)
    params = {"w": jnp.asarray(rng.randn(8, 8) * 0.3, jnp.float32)}
    kw = dict(block_size=8, second_moment_decay=0.9)
    tx_e = shampoo.apply(shampoo.Options(**kw, solver_backend="eigh"))
    tx_f = shampoo.apply(shampoo.Options(**kw, solver_backend="filtered"))
    se, sf = tx_e.init(params), tx_f.init(params)
    for i in range(6):
      g = {"w": jnp.asarray(rng.randn(8, 8) * 0.1, jnp.float32)}
      ue, se = tx_e.update(g, se, params)
      uf, sf = tx_f.update(g, sf, params)
      chex.assert_tree_all_finite(uf)
      # Unlike the ridge backend (which needs full-rank stats), the
      # filtered backend tracks eigh from the rank-deficient start.
      chex.assert_trees_all_close(ue, uf, rtol=0.1, atol=5e-3)

  def test_auto_resolves_to_eigh_off_tpu(self):
    assert shampoo._resolve_solver("auto") == "eigh"


class TestReshaper:

  def test_merge_pad_roundtrip(self):
    opts = reshaper.Options(merge_dims=6, block_size=4)
    params = {"w": jnp.arange(30.0).reshape(2, 3, 5)}
    m = reshaper.merge(opts)
    u = reshaper.unmerge(opts)
    merged, _ = m.update(params, optax.MaskedNode(), params)
    # [2,3,5] -> merge to [6,5] -> pad to [8, 8].
    assert merged["w"].shape == (8, 8)
    back, _ = u.update(merged, optax.MaskedNode(), params)
    np.testing.assert_array_equal(back["w"], params["w"])

  def test_scalar_collapse(self):
    opts = reshaper.Options(merge_dims=4, block_size=4)
    params = {"w": jnp.ones((1, 1))}
    merged, _ = reshaper.merge(opts).update(params, optax.MaskedNode(), params)
    assert merged["w"].shape == ()

  def test_validation(self):
    with pytest.raises(ValueError):
      reshaper.merge(reshaper.Options(merge_dims=1))
    with pytest.raises(ValueError):
      reshaper.merge(reshaper.Options(block_size=1))


class TestMomentum:

  def test_matches_optax_trace(self):
    params = {"w": jnp.zeros(3)}
    grads = [{"w": jnp.asarray([1.0, -1.0, 2.0]) * i} for i in range(1, 4)]
    opts = momentum.Options(ema=False, nesterov=False, momentum_decay=0.9)
    tx = momentum.apply(opts)
    ref = optax.trace(0.9, False)
    s1, s2 = tx.init(params), ref.init(params)
    for g in grads:
      u1, s1 = tx.update(g, s1, params)
      u2, s2 = ref.update(g, s2, params)
      chex.assert_trees_all_close(u1, u2)

  def test_ema_scaling(self):
    params = {"w": jnp.zeros(2)}
    g = {"w": jnp.asarray([1.0, 2.0])}
    opts = momentum.Options(ema=True, nesterov=False, momentum_decay=0.9)
    tx = momentum.apply(opts)
    s = tx.init(params)
    u, s = tx.update(g, s, params)
    np.testing.assert_allclose(u["w"], 0.1 * np.asarray(g["w"]), rtol=1e-6)

  def test_validation(self):
    with pytest.raises(ValueError):
      momentum.apply(momentum.Options(momentum_decay=-0.1))
    with pytest.raises(ValueError):
      momentum.apply(momentum.Options(weight_decay=-1.0))


class TestGrafting:

  def test_rmsprop_before_start_step(self):
    # Before start_preconditioning_step the graft update passes through.
    opts = grafting.Options(
        grafting_type=grafting.GraftingType.RMSPROP,
        second_moment_decay=1.0, start_preconditioning_step=1000,
        epsilon=0.0)
    direction = grafting._sgd()
    tx = grafting._graft_with(direction, grafting._rmsprop(opts), opts)
    params = {"w": jnp.zeros((3, 2))}
    g = {"w": jnp.full((3, 2), 2.0)}
    state = tx.init(params)
    u, state = tx.update(g, state, params)
    # AdaGrad at step 1: g / sqrt(g^2) = sign(g).
    np.testing.assert_allclose(u["w"], np.ones((3, 2)), rtol=1e-6)

  def test_norm_rescaling(self):
    opts = grafting.Options(
        grafting_type=grafting.GraftingType.SGD,
        second_moment_decay=0.0,
        start_preconditioning_step=0,
        skip_preconditioning_rank1=False)
    scale_tx = optax.scale(7.0)  # direction = 7g, norm = g
    import types
    direction = types.SimpleNamespace(
        init=scale_tx.init, update=scale_tx.update,
        init_partition_spec=lambda p: None)
    tx = grafting.graft(opts, direction)
    params = {"w": jnp.asarray([3.0, 4.0])}
    g = {"w": jnp.asarray([3.0, 4.0])}
    state = tx.init(params)
    u, _ = tx.update(g, state, params)
    # Direction 7g rescaled to ||g||: back to g.
    np.testing.assert_allclose(u["w"], np.asarray(g["w"]), rtol=1e-6)

  def test_skip_masks(self):
    opts = grafting.Options(
        grafting_type=grafting.GraftingType.SGD,
        skip_preconditioning_any_dim_gt=4,
        skip_preconditioning_rank1=True)
    masked = grafting._mask_skipped(
        opts, {"a": jnp.zeros(3), "b": jnp.zeros((2, 8)),
               "c": jnp.zeros((2, 2))})
    assert grafting._masked(masked["a"])
    assert grafting._masked(masked["b"])
    assert not grafting._masked(masked["c"])

  def test_validation(self):
    with pytest.raises(ValueError):
      grafting._validate(grafting.Options(
          grafting_type=grafting.GraftingType.RMSPROP,
          second_moment_decay=0.0))
    with pytest.raises(ValueError):
      grafting._validate(grafting.Options(
          grafting_type=grafting.GraftingType.ADAFACTOR,
          second_moment_decay=1.0))


class TestSketchy:

  def test_full_rank_matches_shampoo(self):
    """At full rank, Sketchy == Shampoo / sqrt(1-decay).

    Oracle from the reference test suite (`sketchy_test.py:315-325`):
    sketchy tracks sum decay^i G G^T while shampoo's EMA carries an extra
    (1-decay); preconditioning with cov^(-1/4) per side turns that into a
    global 1/sqrt(1-decay) (= 10 at decay 0.99) on the update.
    """
    rng = np.random.RandomState(0)
    decay = 0.99
    grads = [jnp.asarray(rng.randn(4, 5), jnp.float32) for _ in range(3)]
    params = {"w": jnp.zeros((4, 5))}

    sk_tx = sketchy.apply(sketchy.Options(
        second_moment_decay=decay, epsilon=0.0))
    sh_tx = shampoo.apply(shampoo.Options(second_moment_decay=decay))
    sk_s, sh_s = sk_tx.init(params), sh_tx.init(params)
    for step, g in enumerate(grads):
      sk_u, sk_s = sk_tx.update({"w": g}, sk_s, params)
      sh_u, sh_s = sh_tx.update({"w": g}, sh_s, params)
      if step == 0:
        # At step 0 the covariance is rank-1 and, with epsilon=0, sketchy
        # inverts unmasked SVD-noise eigenvalues where shampoo's relative
        # eigenvalue cutoff zeroes them — the upstream pair diverges
        # identically there (verified), so the relation starts at step 1.
        continue
      # The step-0 noise stays in both states and costs ~2% here; the
      # upstream implementations show the same drift on these grads, and
      # bit-exact parity with upstream is asserted separately above.
      np.testing.assert_allclose(
          np.asarray(sh_u["w"]) / 10.0, np.asarray(sk_u["w"]),
          rtol=2.5e-2, atol=1e-3)

  def test_fd_covariance_oracle(self):
    """Sketch at rank k tracks top-k of true covariance (numpy eigh oracle)."""
    rng = np.random.RandomState(3)
    d = 6
    decay = 0.99
    # Low-rank-ish gradients so the FD sketch is nearly exact.
    base = rng.randn(d, 2)
    grads = [jnp.asarray(base @ rng.randn(2, 5), jnp.float32)
             for _ in range(3)]
    params = {"w": jnp.zeros((d, 5))}
    tx = sketchy.apply(sketchy.Options(
        rank=d, second_moment_decay=decay, epsilon=0.0))
    state = tx.init(params)
    cov = np.zeros((d, d))
    for g in grads:
      _, state = tx.update({"w": g}, state, params)
      cov = decay * cov + np.asarray(g) @ np.asarray(g).T
    ax = state[1]["w"].axes[0] if isinstance(state, tuple) else None
    ax = state.sketches["w"].axes[0]
    got = np.sort(np.asarray(ax.eigvals) ** 2)[::-1]
    want = np.sort(np.linalg.eigvalsh(cov))[::-1][:len(got)]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)

  def test_validation(self):
    with pytest.raises(ValueError):
      sketchy.apply(sketchy.Options(rank=0))
    with pytest.raises(ValueError):
      sketchy.apply(sketchy.Options(update_freq=0))
    with pytest.raises(ValueError):
      sketchy.apply(sketchy.Options(second_moment_decay=-0.1))


class TestTearfreeFull:

  def _options(self, **kw):
    return optimizer.TearfreeOptions(
        grafting_options=grafting.Options(
            grafting_type=grafting.GraftingType.RMSPROP,
            second_moment_decay=0.99,
            start_preconditioning_step=2,
            skip_preconditioning_rank1=True),
        second_order_options=second_order.Options(
            merge_dims=8,
            shampoo_options=shampoo.Options(block_size=8),
        ),
        momentum_options=momentum.Options(momentum_decay=0.9, **kw))

  def test_finite_trajectory(self):
    params = {"w": jnp.asarray(np.random.RandomState(0).randn(4, 3),
                               jnp.float32),
              "b": jnp.zeros(3)}
    tx = optimizer.tearfree(0.1, self._options())
    state = tx.init(params)
    rng = np.random.RandomState(1)
    for _ in range(5):
      g = jax.tree.map(
          lambda p: jnp.asarray(rng.randn(*p.shape), jnp.float32), params)
      u, state = tx.update(g, state, params)
      params = jax.tree.map(lambda p, x: p + x, params, u)
    chex.assert_tree_all_finite((params, state))

  @requires_reference
  def test_matches_upstream(self):
    from precondition.tearfree import grafting as rg
    from precondition.tearfree import momentum as rm
    from precondition.tearfree import optimizer as ro
    from precondition.tearfree import second_order as rso
    from precondition.tearfree import shampoo as rsh

    params = {"w": jnp.asarray(np.random.RandomState(0).randn(4, 3),
                               jnp.float32)}
    ref_options = ro.TearfreeOptions(
        grafting_options=rg.Options(
            grafting_type=rg.GraftingType.RMSPROP,
            second_moment_decay=0.99,
            start_preconditioning_step=2,
            skip_preconditioning_rank1=True),
        second_order_options=rso.Options(
            merge_dims=8,
            shampoo_options=rsh.Options(block_size=8)),
        momentum_options=rm.Options(momentum_decay=0.9))
    ours_tx = optimizer.tearfree(0.1, self._options())
    ref_tx = ro.tearfree(0.1, ref_options)
    ours_s, ref_s = ours_tx.init(params), ref_tx.init(params)
    rng = np.random.RandomState(1)
    for step in range(5):
      g = jax.tree.map(
          lambda p: jnp.asarray(rng.randn(*p.shape), jnp.float32), params)
      ours_u, ours_s = ours_tx.update(g, ours_s, params)
      ref_u, ref_s = ref_tx.update(g, ref_s, params)
      chex.assert_trees_all_close(ours_u, ref_u, rtol=2e-4, atol=1e-6,
                                  custom_message=f"step {step}")


class TestSmokeDistributed:
  """Equivalent of the reference's optimizer_smoke_test: distributed-ish
  configs stay finite and deterministic (two identical runs agree)."""

  @pytest.mark.parametrize("second_order_type", ["shampoo", "sketchy"])
  def test_finite_and_deterministic(self, second_order_type):
    if second_order_type == "shampoo":
      so = second_order.Options(
          merge_dims=8, shampoo_options=shampoo.Options(block_size=8))
    else:
      so = second_order.Options(
          merge_dims=8,
          second_order_type=second_order.SecondOrderType.SKETCHY,
          shampoo_options=None,
          sketchy_options=sketchy.Options(rank=4))
    options = optimizer.TearfreeOptions(
        grafting_options=grafting.Options(
            grafting_type=grafting.GraftingType.RMSPROP,
            start_preconditioning_step=2),
        second_order_options=so,
        momentum_options=momentum.Options(momentum_decay=0.9))
    params = {"w": jnp.asarray(np.random.RandomState(0).randn(8, 4),
                               jnp.float32),
              "b": jnp.zeros(3)}
    rng = np.random.RandomState(1)
    grads = [jax.tree.map(
        lambda p: jnp.asarray(rng.randn(*p.shape), jnp.float32), params)
        for _ in range(4)]

    def run():
      tx = optimizer.tearfree(0.1, options)
      state = tx.init(params)
      p = params
      for g in grads:
        u, state = tx.update(g, state, p)
        p = jax.tree.map(lambda a, b: a + b, p, u)
      return p

    p1, p2 = run(), run()
    chex.assert_tree_all_finite(p1)
    chex.assert_trees_all_close(p1, p2, rtol=0, atol=0)


class TestInitPartitionSpec:
  """The full tearfree chain must satisfy `init_partition_spec` even when
  chain members are plain optax transforms (the lr stage) — the reference
  raises there instead (`/root/reference/precondition/tearfree/
  praxis_shim.py`), breaking trainer-side sharded state construction."""

  def test_full_chain_spec_matches_state_structure(self):
    from precondition_tpu.tearfree import praxis_shim

    params = {"w": jnp.zeros((8, 4)), "b": jnp.zeros((3,))}
    tx = optimizer.tearfree(0.1, optimizer.TearfreeOptions())
    state = tx.init(params)
    specs = tx.init_partition_spec(params)

    def count(tree, pred):
      return sum(1 for l in jax.tree.leaves(
          tree, is_leaf=lambda x: pred(x) or isinstance(
              x, praxis_shim.WeightHParams)) if pred(l))

    n_arrays = count(state, lambda l: hasattr(l, "shape") and
                     getattr(l, "ndim", -1) >= 0)
    n_hparams = count(specs, lambda l: isinstance(
        l, praxis_shim.WeightHParams))
    assert n_hparams == n_arrays, (n_hparams, n_arrays)

  def test_schedule_lr_stage_also_works(self):
    tx = optimizer.tearfree(
        lambda step: 0.1 / (1.0 + step), optimizer.TearfreeOptions())
    params = {"w": jnp.zeros((8, 4))}
    specs = tx.init_partition_spec(params)
    assert specs is not None
