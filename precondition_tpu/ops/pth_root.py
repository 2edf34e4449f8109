"""Matrix inverse p-th root numerics.

Computes ``(A + eps*I)^{-1/p}`` for symmetric PSD ``A`` — the kernel at the
heart of Shampoo-style preconditioning.  Two algorithms:

* **Coupled Newton iteration** (Higham, *Functions of Matrices*, eq. 7.18):
  an all-matmul inner loop.  Includes the
  production guard rails of the reference implementation
  (`/root/reference/precondition/distributed_shampoo.py:702-940`): a ridge
  retry ladder (eps x10 per retry, up to 6 tries), an error-ratio divergence
  exit (keep the previous iterate if error grew >1.2x), relative epsilon
  scaling by the top eigenvalue, and padding masks so stacked/padded
  statistics batches stay exact.
* **eigh path** (`distributed_shampoo.py:943-1030` behavioural parity):
  symmetric eigendecomposition, eigenvalues clamped at the ridge, root
  formed as ``(U sqrt(e^{-1/p})) @ (U sqrt(e^{-1/p}))^T`` so it is exactly
  symmetric.

Design notes (differences from the reference, which is f64 CPU-style code
vmapped one matrix at a time):

* The iteration dtype is float32 and float64 when ``jax_enable_x64`` is on.
  The eigh path is the accuracy fallback at high condition numbers, exactly
  as the reference tolerates Newton failures above cond 1e6.
* Everything is expressed with `lax.while_loop` + fixed-shape matmuls at
  ``Precision.HIGHEST`` so a `vmap` over a stacked ``[B, n, n]`` statistics
  batch compiles to one batched program.
* `mat_power` takes a *traced* exponent (blocks of different tensor ranks are
  batched together), implemented as square-and-multiply.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Tuple, Union

import jax
from jax import lax
import jax.numpy as jnp
import numpy as np
import optax

from precondition_tpu.utils import pytree
from precondition_tpu.utils.diagnostics import (
    FDDiagnostics, InversePthRootDiagnostics, LOBPCGDiagnostics)

Array = jax.Array
_EPSILON = 1e-25

# Cold-solve power-iteration exit policy knob.  None = the reference's
# tight absolute 1e-6 exit; a float = loose RELATIVE exit at that
# tolerance.  `benchmarks/pi_policy_trajectory.py` uses it to A/B the
# loose policy on CPU training trajectories (PI_POLICY_TRAJ.json).
COLD_POWER_ITERATION_TOLERANCE = None

# Default Newton chunk size when `newton_unroll` is not passed explicitly.
# Chunking amortises the vmapped-while select/copy overhead but multiplies
# compute for fast-converging solves, and near-converged statistics (a few
# iterations) are the common case, so the default stays 1.
DEFAULT_NEWTON_UNROLL = 1


def root_dtype() -> jnp.dtype:
  """Iteration dtype: f64 when x64 is enabled (CPU tests), else f32."""
  return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@pytree.dataclass
class RootMetrics:
  """Diagnostics for one inverse-pth-root solve.

  Mirrors the reference's ``TrainingMetrics`` root fields
  (`distributed_shampoo.py:338-363`) so trainers can scrape them to
  TensorBoard: max entrywise error of ``M_k - I``, iteration count, final
  error ratio, derived max eigenvalue, and how many ridge retries ran.
  """

  error: Array = pytree.field(default_factory=lambda: jnp.zeros([], jnp.float32))
  iterations: Array = pytree.field(default_factory=lambda: jnp.zeros([], jnp.float32))
  error_ratio: Array = pytree.field(default_factory=lambda: jnp.zeros([], jnp.float32))
  max_eigenvalue: Array = pytree.field(default_factory=lambda: jnp.zeros([], jnp.float32))
  retries: Array = pytree.field(default_factory=lambda: jnp.zeros([], jnp.float32))
  # Rich on-demand diagnostics (`generate_diagnostics=True`), MaskedNode
  # otherwise so the default state carries zero extra bytes.  Mirrors the
  # reference's `TrainingMetrics` diagnostics fields
  # (`distributed_shampoo.py:339-364`).
  lobpcg: Any = pytree.field(default_factory=optax.MaskedNode)
  inverse_pth_root_diagnostics: Any = pytree.field(
      default_factory=optax.MaskedNode)
  conditioned_inverse_pth_root_diagnostics: Any = pytree.field(
      default_factory=optax.MaskedNode)
  fd: Any = pytree.field(default_factory=optax.MaskedNode)


def _padding_mask(n: int, padding_start, dtype) -> Array:
  """1-D mask: 1 for rows < padding_start, 0 after."""
  return (jnp.arange(n, dtype=jnp.int32) < padding_start).astype(dtype)


def power_iteration(
    matrix: Array,
    num_iters: int = 100,
    error_tolerance: float = 1e-6,
    precision: lax.Precision = lax.Precision.HIGHEST,
    padding_start: Union[int, Array, None] = None,
    key: Optional[Array] = None,
    relative_tolerance: bool = False,
    relative_floor: float = 1.0,
) -> Tuple[Array, Array]:
  """Top eigenpair of a symmetric PSD matrix by power iteration.

  Behavioural parity with `distributed_shampoo.py:595-652`: deterministic
  start vector (fixed seed so results are reproducible run-to-run), exits
  when the Rayleigh quotient moves less than ``error_tolerance``, and zeroes
  the start vector beyond ``padding_start`` so padded rows never contaminate
  the estimate.

  Returns:
    ``(eigenvector [n], eigenvalue [])``.
  """
  n = matrix.shape[-1]
  # Deterministic start vector. The reference uses a host-side RandomState;
  # we use jax's own PRNG (traceable, device-resident) with a fixed key.
  if key is None:
    key = jax.random.PRNGKey(1729)
  v0 = jax.random.uniform(key, (n,), matrix.dtype, -1.0, 1.0)
  if padding_start is not None:
    v0 = v0 * _padding_mask(n, padding_start, matrix.dtype)

  def cond(state):
    i, _, _, run = state
    return jnp.logical_and(i < num_iters, run)

  def body(state):
    i, v, ev, _ = state
    v = v / jnp.maximum(jnp.linalg.norm(v), _EPSILON)
    mv = jnp.einsum("ij,j->i", matrix, v, precision=precision)
    ev_new = jnp.einsum("i,i->", v, mv, precision=precision)
    if relative_tolerance:
      # The eigenvalue only scales the relative ridge; an absolute 1e-6
      # tolerance over-iterates (each matvec re-reads the matrix from device memory).
      # ``relative_floor=1.0`` makes sub-unit eigenvalues exit immediately
      # (fine for ridge scaling, where a low estimate only shrinks the
      # ridge); pass 0.0 for a genuinely relative exit when the estimate
      # feeds something that needs its magnitude (e.g. the spectral-filter
      # threshold).
      not_done = jnp.abs(ev_new - ev) > error_tolerance * jnp.maximum(
          jnp.abs(ev_new), relative_floor)
    else:
      not_done = jnp.abs(ev_new - ev) > error_tolerance
    return (i + 1, mv, ev_new, not_done)

  _, v, ev, _ = lax.while_loop(
      cond, body, (0, v0, jnp.zeros([], matrix.dtype), True)
  )
  v = v / jnp.maximum(jnp.linalg.norm(v), _EPSILON)
  return v, ev


def mat_power(
    m: Array,
    p: Union[int, Array],
    precision: lax.Precision = lax.Precision.HIGHEST,
) -> Array:
  """``m**p`` by square-and-multiply; ``p`` may be static or traced.

  Parity: `distributed_shampoo.py:655-678`.  When ``p`` is a python int the
  exponentiation unrolls to pure matmuls; a traced-p while_loop under vmap
  adds full-batch select/copy passes to every Newton iteration.  The
  optimizer layers bucket statistics by exponent so the static path is the
  hot one.
  """
  if isinstance(p, int):
    if p <= 0:
      return jnp.eye(m.shape[-1], dtype=m.dtype)
    result = None
    square = m
    bits = p
    while bits:
      if bits & 1:
        result = square if result is None else jnp.matmul(
            result, square, precision=precision)
      bits >>= 1
      if bits:
        square = jnp.matmul(square, square, precision=precision)
    return result

  out = jnp.eye(m.shape[-1], dtype=m.dtype)

  def cond(state):
    i, _, _ = state
    return i > 0

  def body(state):
    i, acc, sq = state
    acc = lax.cond(
        i % 2 == 1,
        lambda: jnp.matmul(sq, acc, precision=precision),
        lambda: acc,
    )
    return i // 2, acc, jnp.matmul(sq, sq, precision=precision)

  _, out, _ = lax.while_loop(cond, body, (jnp.asarray(p, jnp.int32), out, m))
  return out


def pth_root_difference(
    w: Array, alpha: Array, beta: Array, p: Union[int, Array]
) -> Array:
  """Numerically stable ``(w+alpha)^{-1/p} - (w+beta)^{-1/p}``.

  Naive subtraction cancels catastrophically when ``alpha ~ beta``; instead
  factor out the larger term and use ``expm1/log1p`` (parity:
  `distributed_shampoo.py:681-699`). Used to re-deflate LOBPCG eigenvectors
  after the Newton solve.
  """
  a = w + alpha
  b = w + beta
  d = alpha - beta
  exp = -1.0 / p

  def stable(base, diff):
    # base^exp * ((1 + diff/base)^exp - 1), all in log-space.
    return (base**exp) * jnp.expm1(exp * jnp.log1p(diff / base))

  # Pick whichever branch has the smaller log1p argument.
  return jnp.where(jnp.abs(d / b) < jnp.abs(d / a), -stable(a, -d), stable(b, d))


def _mask_matrix(matrix: Array, identity: Array, padding_start):
  """Zero rows/cols >= padding_start of both the matrix and the identity."""
  n = matrix.shape[-1]
  ix = _padding_mask(n, padding_start, matrix.dtype)
  matrix = matrix * ix[None, :] * ix[:, None]
  identity = identity * ix
  return matrix, identity


def matrix_inverse_pth_root(
    matrix: Array,
    p: Union[int, Array],
    num_iters: int = 100,
    ridge_epsilon: float = 1e-6,
    error_tolerance: float = 1e-6,
    precision: lax.Precision = lax.Precision.HIGHEST,
    relative_matrix_epsilon: bool = True,
    lobpcg_topk_precondition: int = 0,
    lobpcg_max_iter: int = 0,
    padding_start: Union[int, Array, None] = None,
    prev: Optional[Array] = None,
    eigh: bool = False,
    retry_loop_error_threshold: float = 0.05,
    num_tries: int = 6,
    max_error_ratio: float = 1.2,
    newton_unroll: Optional[int] = None,
    warm_error_threshold: float = 0.05,
    generate_diagnostics: bool = False,
) -> Tuple[Array, RootMetrics]:
  """``(matrix + eps I)^{-1/p}`` via coupled Newton with production guards.

  Behavioural parity with `distributed_shampoo.py:702-940`:

  * ``relative_matrix_epsilon``: scale the ridge by the top eigenvalue
    (power iteration, or LOBPCG's output when deflation is on).
  * Retry ladder: if the converged error exceeds
    ``retry_loop_error_threshold``, multiply the ridge by 10 and re-solve,
    up to ``num_tries`` times.
  * Divergence guard: inside the Newton loop, exit when the error grows by
    more than ``max_error_ratio`` between iterations and return the
    *previous* iterate.
  * ``padding_start``: rows/cols at and beyond it are zeroed in the input,
    excluded from convergence checks, and exactly zero in the output; a
    pure-padding matrix (``padding_start == 0``) returns all zeros.
  * ``lobpcg_topk_precondition``: deflate the top-k eigenpairs before the
    Newton solve (cuts the condition number), then re-deflate the root with
    the stable `pth_root_difference`.
  * ``prev``: warm start from the previous solve's root.  The reference
    plumbs ``prev`` into this kernel but then discards it
    (`distributed_shampoo.py:764` is literally ``del prev``); here it is
    implemented.  Because the coupled iteration's correctness argument
    needs all iterates to commute, a naive ``H_0 = prev`` start computes
    the wrong matrix.  Instead the first retry round solves the
    *preconditioned* problem: with ``C = prev^{p/2}`` the transformed
    matrix ``M_0 = C (A + eps I) C`` is ~I when statistics moved little,
    so the same inner iteration converges in 1-2 steps to
    ``H = prev * M_0^{-1/p}``.  ``|M_0 - I|`` doubles as the warm-quality
    certificate (see ``warm_error_threshold`` in the body): it bounds
    ``|prev - (A + eps I)^{-1/p}|`` because the SPD solution of
    ``C X C = I`` is unique, so both the non-commutativity error of the
    warm fixed point and garbage ``prev`` inputs are caught *before* the
    iteration runs; a failing prev falls through to the ordinary cold
    ladder.  The warm result is exact when ``prev`` commutes with ``A``
    (in particular when statistics are unchanged) and the drift is
    first-order in the per-recompute statistics change — it does not
    accumulate across solves, because each fixed point is anchored to
    the current statistics.

  A mixed-precision "ladder" (coarse bf16-tier phase, then an invariant
  rebuild, then a full-precision polish) used to be available here.  It is
  RETIRED: the coupled iteration is only
  self-correcting in ``M``; rebuilding ``M = H^p (A + r I)`` once does
  not restore the commutativity of ``H`` with ``A`` that coarse rounding
  destroyed, so the polish converges ``M -> I`` while ``H`` drifts off
  the principal root — the solver then self-reports 1e-6 residuals while
  emitting roots whose true residual is unbounded on ill-conditioned
  input.  Any lower-precision scheme must therefore be judged by the true
  residual (`benchmarks/numerics_check.py`), not the self-reported error.

  Returns:
    ``(root, RootMetrics)``; root in ``matrix.dtype``.
  """
  if eigh:
    return matrix_inverse_pth_root_eigh(
        matrix, p, ridge_epsilon, error_tolerance, precision,
        relative_matrix_epsilon, padding_start, prev,
        generate_diagnostics=generate_diagnostics,
    )
  # Warm starts need an even static exponent (C = prev^{p/2} must be an
  # integer matrix power). Shampoo exponents are always 2 * #factored-axes.
  # LOBPCG deflation changes the matrix the Newton loop actually solves,
  # so `prev` (a root of the undeflated problem) cannot seed it.
  warm = (prev is not None and isinstance(p, int) and p > 0 and p % 2 == 0
          and lobpcg_topk_precondition == 0)
  if not warm:
    prev = None

  assert matrix.shape[-1] == matrix.shape[-2]
  n = matrix.shape[-1]
  orig_dtype = matrix.dtype
  work = root_dtype()
  matrix = matrix.astype(work)
  alpha = jnp.asarray(-1.0 / p, work)
  identity = jnp.eye(n, dtype=work)

  if padding_start is not None:
    matrix, identity = _mask_matrix(matrix, identity, padding_start)

  original_matrix = matrix

  eigvals = eigvecs = None
  lobpcg_diag = None
  if lobpcg_topk_precondition > 0:
    from jax.experimental.sparse import linalg as sparse_linalg

    with jax.named_scope("LOBPCGDeflation"):
      k = lobpcg_topk_precondition
      search = jnp.concatenate(
          [jnp.eye(k, dtype=matrix.dtype),
           jnp.zeros((n - k, k), dtype=matrix.dtype)], axis=0)
      eigvals, eigvecs, lobpcg_iters = sparse_linalg.lobpcg_standard(
          matrix, search, lobpcg_max_iter if lobpcg_max_iter else k)
      if generate_diagnostics:
        lobpcg_diag = LOBPCGDiagnostics.create(
            matrix, eigvals, eigvecs, lobpcg_iters)
      # Deflate so the smallest of the top-k becomes the new spectral radius.
      deflation = eigvals - jnp.min(eigvals)
      scaled = eigvecs * jnp.sqrt(deflation)
      matrix = matrix - jnp.matmul(
          scaled, scaled.T, precision=lax.Precision.HIGHEST)

  if relative_matrix_epsilon:
    if eigvals is not None:
      max_ev = jnp.max(eigvals)
    else:
      with jax.named_scope("PowerIteration"):
        # Warm re-solves converge in 1-2 Newton iterations, so the
        # eigenvalue estimate (which only scales the ridge) dominates
        # their cost; a LOOSE relative exit (1%) cuts the ~100 sequential
        # matvecs to a handful.  A 1% ridge shift moves the root by
        # <= 0.25% in ridge-dominated directions — far inside the warm
        # certificate's 0.05 acceptance bound.  Cold solves keep the
        # reference's tight absolute exit here unless the module-level
        # policy knob opts into the measured loose policy (see
        # COLD_POWER_ITERATION_TOLERANCE).
        cold_tol = COLD_POWER_ITERATION_TOLERANCE
        loose = warm or cold_tol is not None
        _, max_ev = power_iteration(
            matrix, num_iters=100,
            error_tolerance=1e-2 if warm else (cold_tol or 1e-6),
            precision=precision, padding_start=padding_start,
            relative_tolerance=loose)
  else:
    max_ev = jnp.asarray(1.0, work)
  ridge = ridge_epsilon * jnp.maximum(max_ev, _EPSILON)

  # Optionally run several Newton iterations per while-loop trip (see
  # DEFAULT_NEWTON_UNROLL for the tradeoff). Convergence/divergence checks
  # happen at chunk granularity: the iteration is a stable fixed point at
  # M ~= I, so extra iterations past tolerance only polish the root, and
  # the divergence rollback returns the chunk-start iterate (conservative).
  if newton_unroll is None:
    newton_unroll = DEFAULT_NEWTON_UNROLL

  def _newton_phase(i0, m0, h0, err0, phase_precision, phase_tol):
    """Run the coupled iteration at one precision until ``phase_tol``."""

    def cond(state):
      i, _, _, _, error, ratio = state
      keep_going = jnp.logical_and(error > phase_tol,
                                   ratio < max_error_ratio)
      return jnp.logical_and(i < num_iters, keep_going)

    def body(state):
      i, mat_m, mat_h, _, error, _ = state
      block_start_h = mat_h
      for _ in range(newton_unroll):
        # T = (1 - alpha) I + alpha M; then M <- T^p M, H <- H T.
        mat_t = (1 - alpha) * identity + alpha * mat_m
        mat_m = jnp.matmul(mat_power(mat_t, p, phase_precision), mat_m,
                           precision=phase_precision)
        mat_h = jnp.matmul(mat_h, mat_t, precision=phase_precision)
      new_error = jnp.max(jnp.abs(mat_m - identity))
      return (i + newton_unroll, mat_m, mat_h, block_start_h, new_error,
              new_error / error)

    return lax.while_loop(
        cond, body, (i0, m0, h0, h0, err0, jnp.asarray(1.0, work)))

  if n == 1:
    root = (matrix + ridge) ** alpha
    error = jnp.zeros([], jnp.float32)
    iters = jnp.zeros([], jnp.float32)
    ratio = jnp.zeros([], jnp.float32)
    retries = jnp.zeros([], jnp.float32)
  else:
    if warm:
      # Precompute the pieces of the transformed warm problem once:
      # C (A + r I) C = CMC + r * CC for any ridge r the ladder picks.
      prev_w = prev.astype(work)
      if padding_start is not None:
        ixw = _padding_mask(n, padding_start, work)
        prev_w = prev_w * ixw[None, :] * ixw[:, None]
      mat_c = mat_power(prev_w, p // 2, precision)
      cmc = jnp.matmul(mat_c, jnp.matmul(matrix, mat_c, precision=precision),
                       precision=precision)
      cmc = 0.5 * (cmc + cmc.T)
      cc = jnp.matmul(mat_c, mat_c, precision=precision)
      # Ladder rounds: 0 = warm attempt at the base ridge; i >= 1 = cold
      # solves with ridge * 10^(i-1), i.e. the full cold ladder runs if
      # the warm attempt misses the acceptance threshold.
      total_rounds = num_tries + 1
    else:
      total_rounds = num_tries

    def retry_cond(state):
      i, _, _, _, _, failed = state
      return jnp.logical_and(failed, i < total_rounds)

    def retry_body(state):
      i, _, _, _, _, _ = state
      if warm:
        ridge_i = ridge * 10.0 ** jnp.maximum(i - 1, 0).astype(work)
      else:
        ridge_i = ridge * (10.0 ** i)
      damped = matrix + ridge_i * identity
      # z scales the spectrum into the Newton basin of attraction.  The
      # norm clamp guards the all-zero-statistics corner in f32: with a
      # ~1e-31 relative ridge the squared Frobenius sum underflows to 0
      # and an unclamped z goes inf -> NaN (f64, the reference's dtype,
      # never hits this).
      z = (1 + p) / (2 * jnp.maximum(jnp.linalg.norm(damped), _EPSILON))
      m0 = damped * z
      h0 = identity * jnp.power(z, 1.0 / p)
      if warm:
        m0_w = cmc + ridge_i * cc
        # Row-sum bound on the top eigenvalue; when M0 ~ I this keeps
        # z_w = 1 so a near-perfect prev converges in one iteration (the
        # Frobenius scaling the cold path uses would shrink the spectrum
        # by ~sqrt(n) and throw the warm start away).
        bound = jnp.max(jnp.sum(jnp.abs(m0_w), axis=-1))
        z_w = jnp.minimum(1.0, (1 + p) / (2 * jnp.maximum(bound, _EPSILON)))
        err0_w = jnp.max(jnp.abs(m0_w * z_w - identity))
        # err0_w doubles as the warm-quality certificate: for SPD C the
        # equation C (A + r I) C = I has the *unique* solution
        # C = (A + r I)^{-1/2}, so a small |M0 - I| forces
        # prev ~ (A + r I)^{-1/p} in norm and bounds the
        # non-commutativity error of the warm fixed point.  A prev that
        # fails the bound (stale, garbage, or all-zero) falls through to
        # the ordinary cold start in the same round.
        use_warm = jnp.logical_and(i == 0, err0_w <= warm_error_threshold)
        m0 = jnp.where(use_warm, m0_w * z_w, m0)
        h0 = jnp.where(use_warm, prev_w * jnp.power(z_w, 1.0 / p), h0)
      err0 = jnp.max(jnp.abs(m0 - identity))
      iters, mat_m, mat_h, old_h, error, ratio = _newton_phase(
          0, m0, h0, err0, precision, error_tolerance)
      error = jnp.max(jnp.abs(mat_m - identity)).astype(jnp.float32)
      converged = jnp.asarray(ratio < max_error_ratio, mat_h.dtype)
      root = converged * mat_h + (1 - converged) * old_h
      if warm:
        # Warm limits are symmetric only up to small non-commutativity;
        # the SPD root is symmetric, so symmetrising only removes error
        # components.
        root = 0.5 * (root + root.T)
      return (i + 1, root, error, jnp.asarray(iters, jnp.float32),
              jnp.asarray(ratio, jnp.float32),
              error > retry_loop_error_threshold)

    init = (0, identity, jnp.asarray(1000.0, jnp.float32),
            jnp.asarray(100.0, jnp.float32), jnp.asarray(1.0, jnp.float32), True)
    with jax.named_scope("CoupledNewton"):
      retries_i, root, error, iters, ratio, _ = lax.while_loop(
          retry_cond, retry_body, init)
    retries = jnp.asarray(retries_i, jnp.float32)

  conditioned_root = root
  if lobpcg_topk_precondition > 0:
    # The deflated directions were solved with eigenvalue min(eigvals); put
    # back the difference between their true inverse-roots and that one.
    diff = pth_root_difference(ridge, jnp.min(eigvals), eigvals, p)
    scaled = eigvecs * jnp.sqrt(diff)
    root = root - jnp.matmul(scaled, scaled.T, precision=lax.Precision.HIGHEST)
    # Report error against the undeflated problem at the ridge the solver
    # actually used (the retry ladder may have escalated it); measuring
    # against the original ridge would flag perfectly good roots.
    # Round i used ridge * 10^i; `retries` counts completed rounds.
    effective_ridge = ridge * 10.0 ** jnp.maximum(
        jnp.asarray(retries, work) - 1.0, 0.0)
    damped = original_matrix + effective_ridge * identity
    err_mat = jnp.matmul(
        mat_power(root, p, precision), damped, precision=precision) - identity
    if padding_start is not None:
      ix = _padding_mask(n, padding_start, err_mat.dtype)
      err_mat = err_mat * ix[None, :] * ix[:, None]
    error = jnp.max(jnp.abs(err_mat)).astype(jnp.float32)

  if padding_start is not None:
    # Pure-padding inputs (hosts with unequal statistic counts) return zeros.
    root = jnp.where(padding_start == 0, 0.0, root)
    error = jnp.where(padding_start == 0, 0.0, error)

  metrics = RootMetrics(
      error=jnp.asarray(error, jnp.float32),
      iterations=jnp.asarray(iters, jnp.float32),
      error_ratio=jnp.asarray(ratio, jnp.float32),
      max_eigenvalue=jnp.asarray(max_ev, jnp.float32),
      retries=retries,
  )
  if generate_diagnostics:
    # Measure residuals against the problem the ladder actually solved:
    # warm round 0 runs at the base ridge, cold round i at ridge*10^i, so
    # the final effective ridge is 10^(retries - 1 - warm) (floored at 0,
    # which also covers the n == 1 / pure-padding shortcuts).
    eff_pow = jnp.maximum(retries - (2.0 if warm else 1.0), 0.0)
    effective_ridge = ridge * 10.0 ** eff_pow.astype(work)
    damped_full = original_matrix + effective_ridge * identity
    uncond = InversePthRootDiagnostics.create(
        root.astype(work), damped_full, p, padding_start=padding_start)
    if lobpcg_topk_precondition > 0:
      # `matrix` holds the deflated (conditioned) problem at this point.
      damped_cond = matrix + effective_ridge * identity
      cond = InversePthRootDiagnostics.create(
          conditioned_root.astype(work), damped_cond, p,
          padding_start=padding_start)
    else:
      lobpcg_diag = LOBPCGDiagnostics()
      cond = InversePthRootDiagnostics()
    if padding_start is not None:
      # Pure-padding solves report all-zero diagnostics, like the root.
      suppress = lambda x: jnp.where(padding_start == 0, 0.0, x)
      uncond = jax.tree.map(suppress, uncond)
      cond = jax.tree.map(suppress, cond)
      lobpcg_diag = jax.tree.map(suppress, lobpcg_diag)
    metrics = metrics.replace(
        lobpcg=lobpcg_diag,
        inverse_pth_root_diagnostics=uncond,
        conditioned_inverse_pth_root_diagnostics=cond)
  return root.astype(orig_dtype), metrics


def matrix_inverse_pth_root_eigh(
    matrix: Array,
    p: Union[int, Array],
    ridge_epsilon: float = 1e-6,
    error_tolerance: float = 1e-6,
    precision: lax.Precision = lax.Precision.HIGHEST,
    relative_matrix_epsilon: bool = True,
    padding_start: Union[int, Array, None] = None,
    prev: Optional[Array] = None,
    generate_diagnostics: bool = False,
) -> Tuple[Array, RootMetrics]:
  """``(matrix + eps I)^{-1/p}`` via symmetric eigendecomposition.

  Accuracy fallback for ill-conditioned statistics (parity:
  `distributed_shampoo.py:943-1030`). Eigenvalues are clamped at the ridge,
  exact zeros (from padding) map to zero, and the root is formed as
  ``R R^T`` with ``R = U sqrt(e^{-1/p})`` so it is symmetric by construction.
  The reported error is the max residual of ``U^T (A + eps I) U - diag(e)``.

  ``prev`` is accepted for signature parity with the Newton path and
  ignored: a direct factorization has no iteration to warm-start.
  """
  del prev
  assert matrix.shape[-1] == matrix.shape[-2]
  n = matrix.shape[-1]
  orig_dtype = matrix.dtype
  work = root_dtype()
  matrix = matrix.astype(work)
  alpha = jnp.asarray(-1.0 / p, work)
  identity = jnp.eye(n, dtype=work)
  ix = None
  if padding_start is not None:
    ix = _padding_mask(n, padding_start, matrix.dtype)
    matrix, identity = _mask_matrix(matrix, identity, padding_start)
  if relative_matrix_epsilon:
    _, max_ev = power_iteration(
        matrix, num_iters=100, error_tolerance=error_tolerance,
        precision=precision, padding_start=padding_start)
  else:
    max_ev = jnp.asarray(1.0, work)
  ridge = ridge_epsilon * jnp.maximum(max_ev, error_tolerance)

  regularized = matrix + ridge * identity
  e, u = jnp.linalg.eigh(regularized)
  if ix is not None:
    # eigh sorts ascending: the zero (padding) eigenvalues come first.
    e = e * jnp.flip(ix)
  inv_e = jnp.where(e == 0.0, 0.0, jnp.power(jnp.maximum(e, ridge), alpha))
  sqrt_root = u * jnp.sqrt(inv_e)
  root = jnp.matmul(sqrt_root, sqrt_root.T, precision=precision)
  # Error: how well U diagonalises the regularised input.
  recovered = jnp.matmul(
      u.T, jnp.matmul(regularized, u, precision=precision), precision=precision)
  eig_err = recovered - jnp.diag(e)
  if ix is not None:
    eig_err = eig_err * jnp.flip(ix)
  error = jnp.max(jnp.abs(eig_err)).astype(jnp.float32)
  if padding_start is not None:
    root = jnp.where(padding_start == 0, 0.0, root)
    error = jnp.where(padding_start == 0, 0.0, error)
  metrics = RootMetrics(
      error=error, max_eigenvalue=jnp.asarray(max_ev, jnp.float32))
  if generate_diagnostics:
    uncond = InversePthRootDiagnostics.create(
        root.astype(work), regularized, p, padding_start=padding_start)
    if padding_start is not None:
      uncond = jax.tree.map(
          lambda x: jnp.where(padding_start == 0, 0.0, x), uncond)
    metrics = metrics.replace(
        lobpcg=LOBPCGDiagnostics(),
        inverse_pth_root_diagnostics=uncond,
        conditioned_inverse_pth_root_diagnostics=InversePthRootDiagnostics())
  return root.astype(orig_dtype), metrics


def batched_spectral_projector(
    stats: Array,
    thresholds: Array,
    num_iters: int = 30,
    precision: lax.Precision = lax.Precision.HIGHEST,
) -> Array:
  """Smooth spectral projector ``P ~= 1{eig(A) > threshold}``, batched.

  Matmul-only construction of the step function of a symmetric matrix —
  eigh-style null-space masking without an eigendecomposition.  On ``B_0 = (A - t I) / s`` (spectrum in [-1, 1] for
  ``s >~ lambda_max``) iterate the Newton–Schulz quintic for the matrix
  sign function::

      f(x) = (15 x - 10 x^3 + 3 x^5) / 8

  ``f`` maps [-1, 1] into itself monotonically (``f'(x) =
  15 (1 - x^2)^2 / 8 >= 0``, ``f(1) = 1``) with slope 15/8 at the origin,
  so ``f^k(B_0) -> sign(A - t I)`` and ``P = (I + S) / 2`` is the
  projector onto eigenvalues above ``t``.  Eigenvalues at distance
  ``delta`` (relative to the scale) from the threshold resolve after
  ``log(1/delta) / log(15/8)`` iterations; the default 30 covers the
  1e-6 relative clip the tearfree eigh backend applies
  (`/root/reference/precondition/tearfree/shampoo.py:466-474`) with
  slack for the norm-bound scaling below.

  STABILITY: the spectrum scaling uses a GUARANTEED upper bound on the
  top eigenvalue — ``min(||A||_F, ||A||_inf)``, both >= lambda_max for
  symmetric A — never an iterative estimate.  The quintic diverges
  double-exponentially for |x| >~ 1.3, so any materially low estimate
  (e.g. a loose power-iteration exit on an early-training covariance
  with lambda_max << 1, where an absolute exit floor triggers
  immediately) is fatal, not degraded; a norm bound can only
  OVERestimate, which merely costs ~log_{15/8}(bound/lambda_max) extra
  iterations (<= ~5 at d=128).

  Each iteration is 3 batched ``[N, d, d]`` matmuls (``B^2``, ``B^4``, and
  the polynomial application), so the 30-iteration filter is ~90 batched
  matmuls.

  Args:
    stats: ``[N, d, d]`` symmetric batch.
    thresholds: ``[N]`` absolute eigenvalue cutoffs (e.g. ``eps * λmax``).
    num_iters: sign-iteration count (static).

  Returns:
    ``[N, d, d]`` symmetric projector batch with eigenvalues in [0, 1].
  """
  eye = jnp.eye(stats.shape[-1], dtype=stats.dtype)
  fro = jnp.sqrt(jnp.sum(jnp.square(stats), axis=(1, 2)))
  infn = jnp.max(jnp.sum(jnp.abs(stats), axis=2), axis=1)
  bound = jnp.minimum(fro, infn)
  # The shifted matrix's extremes are lambda_max - t (above) and -t
  # (below); bound >= lambda_max >= both magnitudes for t >= 0, and the
  # threshold term keeps the negative end in basin even if t > bound.
  scale = jnp.maximum(jnp.maximum(bound, thresholds), _EPSILON)[
      :, None, None]
  b0 = (stats - thresholds[:, None, None] * eye) / scale

  def body(_, b):
    c = jnp.einsum("nij,njk->nik", b, b, precision=precision)
    c2 = jnp.einsum("nij,njk->nik", c, c, precision=precision)
    poly = 1.875 * eye - 1.25 * c + 0.375 * c2
    return jnp.einsum("nij,njk->nik", b, poly, precision=precision)

  sign = lax.fori_loop(0, num_iters, body, b0)
  return 0.5 * (sign + eye)


# Unified entry point used by the optimizer layers.
inverse_pth_root = matrix_inverse_pth_root


def batched_inverse_pth_root(
    stats: Array,
    exponents: Union[int, Array],
    padding_starts: Optional[Array] = None,
    prevs: Optional[Array] = None,
    **kwargs,
) -> Tuple[Array, RootMetrics]:
  """vmap of `matrix_inverse_pth_root` over a stacked ``[B, n, n]`` batch.

  This is the unit of work the distribution layer shards across devices:
  each device solves its slice of the batch, then the fresh preconditioners
  are all-gathered (see `precondition_tpu.parallel`).

  Pass a python-int ``exponents`` when the whole batch shares one exponent:
  the inner `mat_power` then unrolls statically instead of running the
  traced-exponent loop (the optimizer buckets statistics by exponent to
  exploit this).

  ``prevs`` (``[B, n, n]``, optional) warm-starts each solve from the
  previous roots; under vmap the whole batch pays the iteration count of
  its slowest member, so warm starts pay off exactly when the batch is
  uniformly near-converged — the production steady state.
  """
  fn = functools.partial(matrix_inverse_pth_root, **kwargs)
  if padding_starts is None:
    padding_starts = jnp.full((stats.shape[0],), stats.shape[-1], jnp.int32)
  if isinstance(exponents, int):
    if prevs is None:
      return jax.vmap(lambda m, s: fn(m, exponents, padding_start=s))(
          stats, padding_starts)
    return jax.vmap(
        lambda m, s, w: fn(m, exponents, padding_start=s, prev=w))(
            stats, padding_starts, prevs)
  if prevs is None:
    return jax.vmap(lambda m, p, s: fn(m, p, padding_start=s))(
        stats, exponents, padding_starts)
  # Traced exponents cannot warm start (C = prev^{p/2} needs a static p);
  # matrix_inverse_pth_root ignores prev in that case, so don't pay the
  # vmap plumbing for it.
  return jax.vmap(lambda m, p, s: fn(m, p, padding_start=s))(
      stats, exponents, padding_starts)
