"""Rich per-preconditioner diagnostics for dashboard scraping.

Equivalents of the reference's diagnostics dataclasses
(`/root/reference/precondition/distributed_shampoo.py:109-335`): entrywise
inverse-root residuals, LOBPCG eigenpair consistency, and the 20-field FD
sketch health report.  All leaves are f32 scalars so the structs travel in
optimizer state and stream straight to TensorBoard.
"""

from __future__ import annotations

import functools
from typing import Union

import jax
from jax import lax
import jax.numpy as jnp
import optax

from precondition_tpu.utils import pytree


def _zero():
  return pytree.field(default_factory=functools.partial(
      jnp.array, 0, jnp.float32))


@pytree.dataclass
class InversePthRootDiagnostics:
  """Entrywise residual of ``B^p A - I`` for a computed root ``B``."""

  max_diag_error: jax.Array = _zero()
  avg_diag_error: jax.Array = _zero()
  max_off_diag_error: jax.Array = _zero()
  avg_off_diag_error: jax.Array = _zero()
  p: jax.Array = _zero()

  @classmethod
  def create(cls, pth_inverse_root, matrix, p, padding_start=None):
    # Local import: pth_root imports this module for the diagnostics types.
    from precondition_tpu.ops.pth_root import mat_power

    mat_m = jnp.matmul(mat_power(pth_inverse_root, p), matrix,
                       precision=lax.Precision.HIGHEST)
    n = mat_m.shape[0]
    if padding_start is None:
      valid = jnp.ones((n,), mat_m.dtype)
      count = jnp.asarray(n, jnp.float32)
    else:
      # Padded rows/cols hold zeros; exclude them so a padded block does
      # not report |0 - 1| = 1 diagonal "error" (the reference computes
      # these unmasked because it only attaches them in un-padded LOBPCG
      # runs).
      valid = (jnp.arange(n) < padding_start).astype(mat_m.dtype)
      count = jnp.maximum(jnp.asarray(padding_start, jnp.float32), 1.0)
    num_off_diag = jnp.maximum(count * count - count, 1.0)
    diag_error = (jnp.abs(jnp.diag(mat_m) - 1) * valid).astype(jnp.float32)
    off_diag_error = (jnp.abs(mat_m - jnp.diag(jnp.diag(mat_m)))
                      * valid[:, None] * valid[None, :]).astype(jnp.float32)
    return cls(
        max_diag_error=jnp.max(diag_error),
        avg_diag_error=jnp.sum(diag_error) / count,
        max_off_diag_error=jnp.max(off_diag_error),
        avg_off_diag_error=jnp.sum(off_diag_error) / num_off_diag,
        p=jnp.array(p, jnp.float32))


@pytree.dataclass
class LOBPCGDiagnostics:
  """Eigenpair consistency ``|Av - λv| / (λ + |Av|)`` and orthogonality."""

  lobpcg_iters: jax.Array = _zero()
  max_consistency_error: jax.Array = _zero()
  avg_consistency_error: jax.Array = _zero()
  avg_orthogonality_error: jax.Array = _zero()
  max_eigenvalue: jax.Array = _zero()
  min_eigenvalue: jax.Array = _zero()
  num_topk_eigenvectors: jax.Array = _zero()

  @classmethod
  def create(cls, matrix, eigvals, eigvecs, lobpcg_iters):
    num_topk = len(eigvals)
    num_off_diag = num_topk * (num_topk - 1)
    mat_eigvecs = matrix.dot(eigvecs, precision=lax.Precision.HIGHEST)
    consistency_raw = jnp.linalg.norm(
        mat_eigvecs - eigvals * eigvecs, ord=2, axis=0)
    normalization = jnp.linalg.norm(mat_eigvecs, ord=2, axis=0) + eigvals
    consistency = consistency_raw / normalization
    ortho = eigvecs.T.dot(eigvecs, precision=lax.Precision.HIGHEST)
    ortho = ortho - jnp.diag(jnp.diag(ortho))
    return cls(
        lobpcg_iters=jnp.array(lobpcg_iters, jnp.float32),
        max_consistency_error=jnp.max(consistency).astype(jnp.float32),
        avg_consistency_error=jnp.mean(consistency).astype(jnp.float32),
        avg_orthogonality_error=(jnp.sum(ortho) / num_off_diag).astype(
            jnp.float32),
        max_eigenvalue=jnp.max(eigvals).astype(jnp.float32),
        min_eigenvalue=jnp.min(eigvals).astype(jnp.float32),
        num_topk_eigenvectors=jnp.array(num_topk, jnp.float32))


@pytree.dataclass
class FDDiagnostics:
  """Health report for frequent-directions preconditioner updates."""

  size_max_size: jax.Array = _zero()
  size_rank: jax.Array = _zero()
  size_padding_start: jax.Array = _zero()
  rho: jax.Array = _zero()            # latest deflation amount
  tail: jax.Array = _zero()           # cumulative escaped mass
  eig_sparsity: jax.Array = _zero()
  eig_max: jax.Array = _zero()
  eig_min: jax.Array = _zero()
  new_grad_abs_max: jax.Array = _zero()
  new_grad_sparsity: jax.Array = _zero()
  new_grad_col_sparsity: jax.Array = _zero()
  ggt_eig_max: jax.Array = _zero()
  ggt_intrinsic_dimension: jax.Array = _zero()
  max_ortho_err: jax.Array = _zero()
  num_neg_eigs: jax.Array = _zero()
  num_zero_initial_eigs: jax.Array = _zero()
  num_unsafe_norms: jax.Array = _zero()
  num_has_padding: jax.Array = _zero()
  square_frob: jax.Array = _zero()
  heuristic_frob: jax.Array = _zero()
  entrywise_err: jax.Array = _zero()
  total_frob: jax.Array = _zero()

  @classmethod
  def create(cls, rho, tail, eigs, new_grad, eigvecs, padding_start,
             max_size, num_neg_eigs, num_zero_initial_eigs,
             num_unsafe_norms, num_has_padding, frob, expected_frob,
             entrywise_svd_err, total_frob):
    max_size_, rank = eigvecs.shape
    eig_max = jnp.max(eigs).astype(jnp.float32)
    eig_min = jnp.min(eigs, where=eigs.astype(bool), initial=eig_max)
    padding_ix = jnp.arange(max_size_) >= padding_start
    nonpad = 1 - padding_ix
    mask = nonpad * nonpad[:, None]
    new_grad = new_grad * mask
    ggt = jnp.matmul(new_grad, new_grad.T, precision=lax.Precision.HIGHEST)
    ggt_eigs = jnp.linalg.eigvalsh(ggt)
    ggt_eig_max = jnp.max(ggt_eigs)
    cross = jnp.matmul(eigvecs.T, eigvecs, precision=lax.Precision.HIGHEST)
    ortho_err = jnp.abs(cross - jnp.diag(jnp.diag(cross)))
    col_l1 = jnp.abs(new_grad).sum(axis=0)
    return cls(
        size_max_size=jnp.array(max_size).astype(jnp.float32),
        size_rank=jnp.array(rank).astype(jnp.float32),
        size_padding_start=jnp.array(padding_start).astype(jnp.float32),
        rho=jnp.asarray(rho, jnp.float32),
        tail=jnp.asarray(tail, jnp.float32),
        eig_sparsity=(eigs == 0).mean(),
        eig_max=eig_max,
        eig_min=eig_min,
        new_grad_abs_max=jnp.max(jnp.abs(new_grad)).astype(jnp.float32),
        new_grad_sparsity=jnp.sum(mask * (new_grad == 0)).astype(jnp.float32)
        / padding_start**2,
        new_grad_col_sparsity=jnp.sum(nonpad * (col_l1 == 0)).astype(
            jnp.float32) / padding_start,
        ggt_eig_max=ggt_eig_max,
        ggt_intrinsic_dimension=jnp.trace(ggt) / ggt_eig_max,
        max_ortho_err=jnp.max(ortho_err).astype(jnp.float32),
        num_neg_eigs=jnp.asarray(num_neg_eigs, jnp.float32),
        num_zero_initial_eigs=jnp.asarray(num_zero_initial_eigs, jnp.float32),
        num_unsafe_norms=jnp.asarray(num_unsafe_norms, jnp.float32),
        num_has_padding=jnp.asarray(num_has_padding, jnp.float32),
        square_frob=frob,
        heuristic_frob=expected_frob,
        entrywise_err=entrywise_svd_err,
        total_frob=total_frob)
