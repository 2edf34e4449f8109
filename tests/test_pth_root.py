"""Numerics contract tests for the inverse-pth-root core.

Mirrors the reference test strategy (SURVEY.md §4): conditioned-matrix
property tests, padding invariance, stability micro-tests, plus direct
oracle comparison against the upstream implementation.
"""

import numpy as np
import pytest
import scipy.stats

import jax
import jax.numpy as jnp

from benchmarks import numerics_check
from precondition_tpu.ops import pth_root

from conftest import requires_reference


def _conditioned_matrix(rng, n, condition):
  """Symmetric PSD matrix with exact condition number `condition`."""
  q = scipy.stats.ortho_group.rvs(dim=n, random_state=rng)
  eigs = np.logspace(0, np.log10(condition), n)
  return (q * eigs).dot(q.T).astype(np.float32)


def _reference_root(mat, p, eps):
  """Dense oracle: eigh-based (A + eps*lambda_max I)^{-1/p} in f64."""
  mat = np.asarray(mat, np.float64)
  e, u = np.linalg.eigh(mat)
  ridge = eps * max(e.max(), 1e-25)
  e = np.maximum(e + ridge, ridge)
  return (u * e ** (-1.0 / p)).dot(u.T)


class TestPowerIteration:

  def test_matches_eigh(self):
    rng = np.random.RandomState(0)
    mat = _conditioned_matrix(rng, 16, 1e3)
    _, ev = pth_root.power_iteration(jnp.asarray(mat))
    np.testing.assert_allclose(ev, np.linalg.eigvalsh(mat).max(), rtol=1e-4)

  def test_padding(self):
    rng = np.random.RandomState(1)
    mat = _conditioned_matrix(rng, 8, 1e2)
    padded = np.zeros((12, 12), np.float32)
    padded[:8, :8] = mat
    _, ev = pth_root.power_iteration(jnp.asarray(padded), padding_start=8)
    np.testing.assert_allclose(ev, np.linalg.eigvalsh(mat).max(), rtol=1e-4)


class TestMatPower:

  @pytest.mark.parametrize("reference", ["numpy", "traced"])
  @pytest.mark.parametrize("p", [1, 2, 3, 4, 6, 8])
  def test_static_exponent(self, p, reference):
    """The unrolled static-exponent power against numpy's and against the
    traced-exponent while_loop."""
    if reference == "numpy":
      m = np.random.RandomState(2).randn(6, 6).astype(np.float32) * 0.3
      want = np.linalg.matrix_power(m, p)
      rtol, atol = 2e-4, 2e-5
    else:
      m = np.random.RandomState(p).randn(8, 8).astype(np.float32) * 0.3
      want = pth_root.mat_power(jnp.asarray(m), jnp.asarray(p))
      rtol, atol = 1e-5, 1e-6
    got = pth_root.mat_power(jnp.asarray(m), p)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)

  def test_traced_exponent(self):
    m = jnp.eye(4) * 2.0
    got = jax.jit(pth_root.mat_power)(m, jnp.asarray(3))
    np.testing.assert_allclose(got, np.eye(4) * 8.0, rtol=1e-6)

  def test_static_exponent_solve_matches(self):
    rng = np.random.RandomState(0)
    s = rng.randn(3, 12, 12).astype(np.float32)
    stats = jnp.einsum("nij,nkj->nik", s, s) / 12
    pads = jnp.full((3,), 12, jnp.int32)
    r_static, m_static = pth_root.batched_inverse_pth_root(stats, 4, pads)
    r_dyn, m_dyn = pth_root.batched_inverse_pth_root(
        stats, jnp.full((3,), 4, jnp.int32), pads)
    np.testing.assert_allclose(r_static, r_dyn, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m_static.error, m_dyn.error, rtol=1e-3)


class TestPthRootDifference:

  def test_against_f64_naive(self):
    # Grid parity with the reference's stability micro-test.
    for p in [2, 4, 6, 8]:
      for w in [1e-6, 1e-3, 1.0, 1e3]:
        for a in [1e-6, 1e-2, 1.0]:
          for b in [1e-6, 1e-2, 1.0]:
            got = pth_root.pth_root_difference(
                jnp.float32(w), jnp.float32(a), jnp.float32(b), p)
            want = (np.float64(w + a) ** (-1 / p)
                    - np.float64(w + b) ** (-1 / p))
            np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-7)


class TestInversePthRoot:

  @pytest.mark.parametrize("e", [0, 2, 4, 6])
  @pytest.mark.parametrize("p", [2, 4])
  def test_conditioned_matrices(self, e, p):
    # Error < 0.1 required up to condition 1e6 (BASELINE.md row 3).
    rng = np.random.RandomState(e + p)
    mat = _conditioned_matrix(rng, 16, 10.0**e)
    root, metrics = pth_root.matrix_inverse_pth_root(jnp.asarray(mat), p)
    assert np.isfinite(root).all()
    assert float(metrics.error) < 0.1, float(metrics.error)
    want = _reference_root(mat, p, 1e-6)
    rel = np.abs(np.asarray(root, np.float64) - want) / np.abs(want).max()
    assert rel.max() < 0.2 if e >= 6 else rel.max() < 1e-2

  @pytest.mark.parametrize("p", [2, 4, 8])
  def test_identity(self, p):
    root, metrics = pth_root.matrix_inverse_pth_root(jnp.eye(8), p)
    np.testing.assert_allclose(root, np.eye(8) * (1 + 1e-6) ** (-1.0 / p),
                               rtol=1e-3, atol=1e-4)
    assert float(metrics.error) < 1e-3

  def test_scalar_matrix(self):
    root, _ = pth_root.matrix_inverse_pth_root(jnp.asarray([[4.0]]), 2)
    np.testing.assert_allclose(root, [[0.5]], rtol=1e-3)

  @pytest.mark.parametrize("n", [4, 32])
  def test_padding_invariance(self, n):
    # Root of [[M,0],[0,I]] principal block must match unpadded root.
    rng = np.random.RandomState(n)
    mat = _conditioned_matrix(rng, n, 1e3)
    pad_n = n + 5
    padded = np.zeros((pad_n, pad_n), np.float32)
    padded[:n, :n] = mat
    padded[range(n, pad_n), range(n, pad_n)] = 1.0

    base, _ = pth_root.matrix_inverse_pth_root(
        jnp.asarray(mat), 4, relative_matrix_epsilon=False)
    padded_root, _ = pth_root.matrix_inverse_pth_root(
        jnp.asarray(padded), 4, relative_matrix_epsilon=False)
    rtol = 1e-2 if n == 4 else 5e-2
    np.testing.assert_allclose(padded_root[:n, :n], base, rtol=rtol, atol=1e-3)

  def test_padding_start_zeroes_rows(self):
    rng = np.random.RandomState(7)
    mat = _conditioned_matrix(rng, 8, 1e2)
    padded = np.zeros((12, 12), np.float32)
    padded[:8, :8] = mat
    root, _ = pth_root.matrix_inverse_pth_root(
        jnp.asarray(padded), 4, padding_start=8)
    np.testing.assert_array_equal(root[8:, :], 0.0)
    np.testing.assert_array_equal(root[:, 8:], 0.0)
    base, _ = pth_root.matrix_inverse_pth_root(jnp.asarray(mat), 4)
    np.testing.assert_allclose(root[:8, :8], base, rtol=1e-3, atol=1e-4)

  def test_all_padding_returns_zero(self):
    root, metrics = pth_root.matrix_inverse_pth_root(
        jnp.eye(8), 2, padding_start=0)
    np.testing.assert_array_equal(root, 0.0)
    assert float(metrics.error) == 0.0

  def test_eigh_path(self):
    rng = np.random.RandomState(11)
    mat = _conditioned_matrix(rng, 16, 1e4)
    root, metrics = pth_root.matrix_inverse_pth_root(
        jnp.asarray(mat), 4, eigh=True)
    want = _reference_root(mat, 4, 1e-6)
    np.testing.assert_allclose(root, want, rtol=2e-2, atol=1e-3)
    # error metric is an absolute residual; scale by the spectral radius.
    assert float(metrics.error) < 1e-4 * float(metrics.max_eigenvalue)
    # symmetric by construction
    np.testing.assert_allclose(root, np.asarray(root).T, rtol=1e-6)

  def test_eigh_padding(self):
    rng = np.random.RandomState(13)
    mat = _conditioned_matrix(rng, 8, 1e2)
    padded = np.zeros((12, 12), np.float32)
    padded[:8, :8] = mat
    root, _ = pth_root.matrix_inverse_pth_root(
        jnp.asarray(padded), 4, padding_start=8, eigh=True)
    np.testing.assert_array_equal(root[8:, :], 0.0)
    base, _ = pth_root.matrix_inverse_pth_root(jnp.asarray(mat), 4, eigh=True)
    np.testing.assert_allclose(root[:8, :8], base, rtol=1e-3, atol=1e-4)

  @pytest.mark.parametrize("p", [2, 4])
  def test_lobpcg_deflation(self, p):
    """Deflated root at least half as accurate as the default path.

    Criterion mirrors the upstream test
    (`distributed_shampoo_test.py:431-477`): recover the inverse by
    repeated squaring, compare spectrum/entry errors against the
    non-deflated solve, with a converged LOBPCG (max_iter 10).
    """
    rng = np.random.RandomState(42)
    n = 11
    asym = rng.random((n, n)).astype(np.float32)
    mat = jnp.asarray(asym.T @ asym)
    log2 = (p - 1).bit_length()

    errs = {}
    for key, kwargs in [("default", {}),
                        ("precond", dict(lobpcg_topk_precondition=2,
                                         lobpcg_max_iter=10))]:
      root, _ = pth_root.matrix_inverse_pth_root(
          mat, p, ridge_epsilon=1e-4, **kwargs)
      inv = np.asarray(root, np.float64)
      for _ in range(log2):
        inv = inv @ inv
      approx_id = inv @ np.asarray(mat, np.float64)
      errs[key] = (np.abs(1 - np.linalg.eigvalsh(approx_id)),
                   np.mean(np.abs(approx_id - np.eye(n))))
    assert np.median(errs["precond"][0]) <= 2 * np.median(errs["default"][0])
    assert errs["precond"][1] <= 2 * errs["default"][1]

  def test_batched(self):
    rng = np.random.RandomState(19)
    mats = np.stack([
        np.pad(_conditioned_matrix(rng, 8, 1e2), ((0, 4), (0, 4)))
        + np.diag([0.0] * 8 + [1.0] * 4),
        _conditioned_matrix(rng, 12, 1e3),
    ])
    exps = jnp.asarray([4, 2], jnp.int32)
    pads = jnp.asarray([8, 12], jnp.int32)
    roots, metrics = pth_root.batched_inverse_pth_root(
        jnp.asarray(mats), exps, pads)
    assert roots.shape == (2, 12, 12)
    assert np.isfinite(roots).all()
    assert (np.asarray(metrics.error) < 0.1).all()
    np.testing.assert_array_equal(np.asarray(roots[0])[8:, :], 0.0)


@requires_reference
class TestAgainstUpstream:
  """Direct numerics parity with google-research/precondition."""

  @pytest.mark.parametrize("p", [2, 4])
  @pytest.mark.parametrize("e", [1, 3, 5])
  def test_newton_root_matches(self, p, e):
    from precondition import distributed_shampoo as ref

    rng = np.random.RandomState(p * 10 + e)
    mat = _conditioned_matrix(rng, 16, 10.0**e)
    ours, m_ours = pth_root.matrix_inverse_pth_root(jnp.asarray(mat), p)
    theirs, m_theirs = ref.matrix_inverse_pth_root(jnp.asarray(mat), p)
    # Start vectors for the relative-epsilon power iteration differ, so the
    # effective ridge differs in the last few digits: compare loosely.
    np.testing.assert_allclose(ours, theirs, rtol=5e-3, atol=1e-4)
    assert abs(float(m_ours.error) -
               float(m_theirs.inverse_pth_root_errors)) < 5e-2

  def test_eigh_root_matches(self):
    from precondition import distributed_shampoo as ref

    rng = np.random.RandomState(3)
    mat = _conditioned_matrix(rng, 12, 1e4)
    ours, _ = pth_root.matrix_inverse_pth_root(jnp.asarray(mat), 4, eigh=True)
    theirs, _ = ref.matrix_inverse_pth_root(jnp.asarray(mat), 4, eigh=True)
    np.testing.assert_allclose(ours, theirs, rtol=5e-3, atol=1e-4)

  def test_pth_root_difference_matches(self):
    from precondition import distributed_shampoo as ref

    for p in [2, 4, 8]:
      got = pth_root.pth_root_difference(
          jnp.float32(1e-3), jnp.float32(0.5), jnp.float32(0.25), p)
      want = ref._pth_root_difference(
          jnp.float32(1e-3), jnp.float32(0.5), jnp.float32(0.25), p)
      np.testing.assert_allclose(got, want, rtol=1e-5)


class TestWarmStart:
  """`prev` warm starts (the transformed-problem formulation).

  The reference accepts `prev` but discards it (`distributed_shampoo.py:764`
  is `del prev`); these tests pin down the semantics our implementation
  adds: warm == cold at solver tolerance, certified fallback on bad prevs,
  fewer iterations on near-converged statistics.
  """

  def _drifted_pair(self, rng, n=16, condition=1e4, decay=0.999):
    mat = _conditioned_matrix(rng, n, condition)
    grad = rng.randn(n, 4).astype(np.float32)
    drifted = decay * mat + (1 - decay) * grad.dot(grad.T) / 4
    return jnp.asarray(mat), jnp.asarray(drifted)

  @pytest.mark.parametrize("p", [2, 4, 8])
  def test_warm_matches_cold(self, p):
    rng = np.random.RandomState(p)
    mat, drifted = self._drifted_pair(rng)
    cold0, _ = pth_root.matrix_inverse_pth_root(mat, p)
    warm, m_warm = pth_root.matrix_inverse_pth_root(drifted, p, prev=cold0)
    cold, m_cold = pth_root.matrix_inverse_pth_root(drifted, p)
    np.testing.assert_allclose(warm, cold, rtol=1e-3, atol=1e-4)
    assert float(m_warm.iterations) <= float(m_cold.iterations)
    assert float(m_warm.error) < 1e-3

  def test_warm_fewer_iterations_near_converged(self):
    rng = np.random.RandomState(0)
    mat, drifted = self._drifted_pair(rng, condition=1e3)
    cold0, _ = pth_root.matrix_inverse_pth_root(mat, 4)
    warm, m_warm = pth_root.matrix_inverse_pth_root(drifted, 4, prev=cold0)
    _, m_cold = pth_root.matrix_inverse_pth_root(drifted, 4)
    assert float(m_warm.iterations) <= 3
    assert float(m_cold.iterations) > float(m_warm.iterations)

  def test_garbage_prev_certified_fallback(self):
    rng = np.random.RandomState(1)
    mat = jnp.asarray(_conditioned_matrix(rng, 16, 1e4))
    garbage = jnp.asarray(rng.randn(16, 16).astype(np.float32) * 100.0)
    warm, m_warm = pth_root.matrix_inverse_pth_root(mat, 4, prev=garbage)
    cold, _ = pth_root.matrix_inverse_pth_root(mat, 4)
    np.testing.assert_allclose(warm, cold, rtol=1e-4, atol=1e-5)
    assert float(m_warm.error) < 1e-3

  def test_zero_prev_certified_fallback(self):
    rng = np.random.RandomState(2)
    mat = jnp.asarray(_conditioned_matrix(rng, 16, 1e2))
    warm, _ = pth_root.matrix_inverse_pth_root(
        mat, 4, prev=jnp.zeros((16, 16)))
    cold, _ = pth_root.matrix_inverse_pth_root(mat, 4)
    np.testing.assert_allclose(warm, cold, rtol=1e-4, atol=1e-5)

  def test_identical_stats_one_iteration(self):
    """Unchanged statistics: the warm certificate sees M0 == I and the
    solve exits immediately with prev (the commuting exact case)."""
    rng = np.random.RandomState(3)
    mat = jnp.asarray(_conditioned_matrix(rng, 16, 1e3))
    cold, _ = pth_root.matrix_inverse_pth_root(mat, 4)
    warm, m_warm = pth_root.matrix_inverse_pth_root(mat, 4, prev=cold)
    assert float(m_warm.iterations) <= 1
    np.testing.assert_allclose(warm, cold, rtol=1e-4, atol=1e-5)

  def test_odd_exponent_ignores_prev(self):
    rng = np.random.RandomState(4)
    mat = jnp.asarray(_conditioned_matrix(rng, 12, 1e2))
    cold, _ = pth_root.matrix_inverse_pth_root(mat, 3)
    warm, _ = pth_root.matrix_inverse_pth_root(mat, 3, prev=cold)
    np.testing.assert_array_equal(np.asarray(warm), np.asarray(cold))

  def test_warm_with_padding(self):
    rng = np.random.RandomState(5)
    mat = _conditioned_matrix(rng, 8, 1e3)
    padded = np.zeros((12, 12), np.float32)
    padded[:8, :8] = mat
    cold, _ = pth_root.matrix_inverse_pth_root(
        jnp.asarray(padded), 4, padding_start=8)
    warm, m_warm = pth_root.matrix_inverse_pth_root(
        jnp.asarray(padded) * 1.001, 4, padding_start=8, prev=cold)
    np.testing.assert_array_equal(np.asarray(warm)[8:, :], 0.0)
    base, _ = pth_root.matrix_inverse_pth_root(
        jnp.asarray(padded) * 1.001, 4, padding_start=8)
    np.testing.assert_allclose(warm, base, rtol=1e-3, atol=1e-4)

  def test_batched_warm(self):
    rng = np.random.RandomState(6)
    stats = []
    for i in range(6):
      stats.append(_conditioned_matrix(rng, 12, 10.0 ** (1 + i % 4)))
    stats = jnp.asarray(np.stack(stats))
    pads = jnp.full((6,), 12, jnp.int32)
    cold, _ = pth_root.batched_inverse_pth_root(stats, 4, pads)
    drifted = stats * 1.002
    warm, m_warm = pth_root.batched_inverse_pth_root(
        drifted, 4, pads, prevs=cold)
    ref, m_ref = pth_root.batched_inverse_pth_root(drifted, 4, pads)
    np.testing.assert_allclose(warm, ref, rtol=1e-3, atol=1e-4)
    assert float(jnp.max(m_warm.iterations)) <= float(
        jnp.max(m_ref.iterations))


class TestSpectralProjector:
  """Matmul-only smooth step function of a symmetric matrix."""

  def test_projects_onto_above_threshold_eigenspace(self):
    rng = np.random.RandomState(11)
    d, n = 24, 4
    covs = []
    for _ in range(n):
      q = scipy.stats.ortho_group.rvs(dim=d, random_state=rng)
      # Eigenvalues split cleanly across the threshold: huge vs tiny.
      w = np.where(rng.rand(d) > 0.5, np.exp(rng.rand(d) * 3),
                   1e-9 * rng.rand(d))
      covs.append((q * w).dot(q.T).astype(np.float32))
    covs = jnp.asarray(np.stack(covs))
    maxevs = jnp.asarray([np.linalg.eigvalsh(c)[-1] for c in covs],
                         jnp.float32)
    proj = np.asarray(pth_root.batched_spectral_projector(
        covs, 1e-6 * maxevs))
    for c, p in zip(np.asarray(covs), proj):
      w, u = np.linalg.eigh(np.asarray(c, np.float64))
      # In the matrix's own eigenbasis the projector must be ~diag(mask),
      # with the mask read off the actual (f32-rounded) spectrum.
      mask = w > 1e-6 * w.max()
      diag = np.diag(u.T @ p @ u)
      np.testing.assert_allclose(diag, mask.astype(float), atol=5e-3)
      # Off-diagonal leakage stays small (P is a polynomial of C).
      off = u.T @ p @ u - np.diag(diag)
      assert np.max(np.abs(off)) < 1e-2

  def test_projector_idempotent_and_symmetric(self):
    rng = np.random.RandomState(12)
    g = rng.randn(3, 16, 40).astype(np.float32)
    covs = jnp.einsum("nif,njf->nij", g, g)
    maxevs = jnp.asarray([np.linalg.eigvalsh(c)[-1] for c in covs],
                         jnp.float32)
    proj = np.asarray(pth_root.batched_spectral_projector(
        covs, 1e-6 * maxevs))
    for p in proj:
      np.testing.assert_allclose(p, p.T, atol=1e-5)
      np.testing.assert_allclose(p @ p, p, atol=5e-3)


def _psd_batch(rng, n, m, ridge=0.1):
  a = rng.randn(n, m, m).astype(np.float32)
  return jnp.einsum("nij,nkj->nik", a, a) / m + ridge * jnp.eye(m)[None]


class TestBatchedRootAgainstFloat64:
  """The batched solver (the optimizer's only root route) against host
  float64, independent of the solver's self-reported error."""

  @pytest.mark.parametrize("p", [2, 4, 8])
  def test_matches_float64_eigh_root(self, p):
    rng = np.random.RandomState(p)
    n, m = 12, 16
    stats = _psd_batch(rng, n, m)
    pads = jnp.full((n,), m, jnp.int32)
    roots, met = pth_root.batched_inverse_pth_root(stats, p, pads)
    summary, failures = numerics_check.compare_with_host(roots, stats, met, p)
    assert not failures, failures
    assert summary["members_cond_le_1e6"] == n
    assert float(jnp.max(met.error)) < 1e-4

  @pytest.mark.parametrize("cond", [1e2, 1e6])
  def test_true_residual_ill_conditioned(self, cond):
    """max |H^p (A + r I) - I| recomputed in float64 stays within the
    float32 storage bound ~100 eps p cond: the contract a coarse-precision
    scheme broke while self-reporting 1e-6."""
    rng = np.random.RandomState(int(np.log10(cond)))
    n, m, p = 4, 32, 4
    stats = numerics_check.conditioned_batch(rng, n, m, cond)
    pads = jnp.full((n,), m, jnp.int32)
    roots, met = pth_root.batched_inverse_pth_root(stats, p, pads)
    damped = numerics_check.regularized(
        stats, numerics_check.effective_ridge(met))
    resid = numerics_check.true_residuals(roots, damped, p)
    assert np.all(resid < max(100 * 1.2e-7 * p * cond, 1.0)), resid

  def test_mixed_padding_with_all_padding_member(self):
    rng = np.random.RandomState(2)
    n, m = 8, 16
    stats = np.array(_psd_batch(rng, n, m))
    sizes = [16, 12, 8, 0, 16, 4, 16, 16]
    for i, d in enumerate(sizes):
      stats[i, d:, :] = 0.0
      stats[i, :, d:] = 0.0
    roots, met = pth_root.batched_inverse_pth_root(
        jnp.asarray(stats), 4, jnp.asarray(sizes, jnp.int32))
    roots = np.asarray(roots)
    np.testing.assert_array_equal(roots[3], 0.0)
    assert float(met.error[3]) == 0.0
    ridges = numerics_check.effective_ridge(met)
    for i, d in enumerate(sizes):
      if d == 0:
        continue
      np.testing.assert_array_equal(roots[i, d:, :], 0.0)
      np.testing.assert_array_equal(roots[i, :, d:], 0.0)
      damped = numerics_check.regularized(stats[i:i + 1, :d, :d],
                                          ridges[i:i + 1])
      want, _ = numerics_check.eigh_roots(damped, 4)
      np.testing.assert_allclose(roots[i, :d, :d], want[0],
                                 rtol=1e-3, atol=1e-5)

  def test_ridge_ladder_member_does_not_derail_batch(self):
    """A near-singular member climbs the ridge ladder while every healthy
    member of the same batch still matches its own float64 root."""
    rng = np.random.RandomState(7)
    n, m = 8, 16
    stats = np.array(_psd_batch(rng, n, m, ridge=0.05))
    q, _ = np.linalg.qr(rng.randn(m, m))
    stats[0] = (q * np.logspace(0, -12, m)).dot(q.T).astype(np.float32)
    roots, met = pth_root.batched_inverse_pth_root(
        jnp.asarray(stats), 4, jnp.full((n,), m, jnp.int32))
    assert bool(jnp.all(jnp.isfinite(roots)))
    alone, met_alone = pth_root.matrix_inverse_pth_root(
        jnp.asarray(stats[0]), 4)
    assert float(met.retries[0]) == float(met_alone.retries)
    assert float(jnp.max(met.retries[1:])) <= 1.0
    summary, failures = numerics_check.compare_with_host(
        roots[1:], stats[1:], jax.tree.map(lambda x: x[1:], met), 4)
    assert not failures, failures
    np.testing.assert_allclose(roots[0], alone, rtol=1e-3, atol=1e-5)

  def test_condition_spread_with_ladder_member(self):
    """The chip smoke's spread batch, small: cond 1e2..1e6 members match
    float64, and the member with a negative eigenvalue below the base
    ridge climbs the ladder and then matches at its escalated ridge."""
    stats = numerics_check.spread_batch(np.random.RandomState(0), 7, 32)
    roots, met = pth_root.batched_inverse_pth_root(
        stats, 4, jnp.full((8,), 32, jnp.int32))
    summary, failures = numerics_check.compare_with_host(roots, stats, met, 4)
    assert not failures, failures
    assert summary["members_cond_le_1e6"] == 8
    assert float(met.retries[-1]) >= 2.0
    assert float(jnp.max(met.retries[:-1])) <= 1.0

  def test_host_check_flags_a_wrong_root(self):
    rng = np.random.RandomState(3)
    stats = _psd_batch(rng, 4, 16)
    roots, met = pth_root.batched_inverse_pth_root(
        stats, 4, jnp.full((4,), 16, jnp.int32))
    _, failures = numerics_check.compare_with_host(
        roots * 1.01, stats, met, 4)
    assert len(failures) == 1 and "1e-3" in failures[0], failures
