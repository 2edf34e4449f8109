"""Sketchy: frequent-directions low-rank covariance sketching.

Feinberg et al., https://arxiv.org/abs/2302.03764.  Tracks, per tensor axis,
a rank-``k`` sketch ``(eigvecs [d,k], eigvals [k])`` of the square root of
the gradient covariance plus a scalar ``tail`` of escaped mass, giving
Shampoo-quality preconditioning in ``O(dk)`` memory instead of ``O(d^2)``.

Update (semantics parity with
`/root/reference/precondition/tearfree/sketchy.py`):
  1. scale the sketch by its eigenvalues and sqrt(decay), append the
     unrolled gradient matrix ``[d, m]``;
  2. QR-reduce then SVD (QR first keeps the SVD input square-ish and works
     around SVD instability on wide inputs; NaN inputs short-circuit to NaN outputs so
     the downstream failure gate can catch them);
  3. deflate by the (k+1)-th singular value, accumulate the escaped mass
     into ``tail`` (or extrapolate it from the eigenvalue log-log slope when
     ``linear_approx_tail``);
  4. invert the shifted spectrum to the -(1/2·ndim) power.

Preconditioning applies the low-rank factor plus ``inv_tail`` times the
orthogonal complement, axis by axis.  Options cover per-layer rank override
(``memory_alloc``), exact-GGT diagnostics (``add_ggt``), and the EKFAC-SVD
variant (preconditioner refreshed every step even when the sketch is
frozen).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional, Union

import jax
import jax.numpy as jnp
import optax

from precondition_tpu.tearfree import praxis_shim


@dataclasses.dataclass
class Options:
  """Sketchy options (see module docstring).

  Attributes:
    epsilon: diagonal perturbation added before inversion.
    rank: FD sketch size per tensor axis.
    relative_epsilon: scale epsilon by the top eigenvalue.
    second_moment_decay: EMA decay of the sketched covariance (1.0 = sum).
    update_freq: steps between sketch updates.
    add_ggt: also track the exact EMA of G G^T (diagnostics).
    memory_alloc: optional per-layer dict path -> [rank per axis].
    ekfac_svd: use the EKFAC-SVD preconditioner (refreshed every step).
    linear_approx_tail: estimate the tail from a log-log linear fit of the
      eigenvalue decay instead of accumulating deflated mass.
  """

  epsilon: float = 1e-7
  rank: int = 128
  relative_epsilon: bool = True
  second_moment_decay: float = 0.999
  update_freq: int = 1
  add_ggt: bool = False
  memory_alloc: Optional[dict] = None
  ekfac_svd: bool = False
  linear_approx_tail: bool = False


def _validate(options: Options) -> None:
  if options.update_freq <= 0:
    raise ValueError(f"update_freq ({options.update_freq}) must be positive")
  if not 0 <= options.second_moment_decay <= 1:
    raise ValueError(
        f"second_moment_decay ({options.second_moment_decay}) "
        "should be in [0, 1]")
  if options.rank <= 0:
    raise ValueError(f"rank ({options.rank}) must be at least 1")


class _AxisState(NamedTuple):
  """Sketch state for one tensor axis (see module docstring)."""

  eigvecs: jax.Array            # [d, k] basis of the covariance sqrt
  eigvals: jax.Array            # [k] eigenvalues of the covariance sqrt
  inv_eigvals: jax.Array        # [k] -(1/2 ndim) root of the covariance
  tail: jax.Array               # [] escaped mass
  inv_tail: jax.Array           # [] its -(1/2 ndim) root
  ema_ggt: Union[optax.MaskedNode, jax.Array]        # [d, d] if add_ggt
  svd_result_u: Union[optax.MaskedNode, jax.Array]   # [d, m] if ekfac_svd
  svd_result_s: Union[optax.MaskedNode, jax.Array]   # [m] if ekfac_svd
  inv_prev_tail: Union[optax.MaskedNode, jax.Array]  # [] if ekfac_svd


class _TensorState(NamedTuple):
  axes: list


class _SketchyState(NamedTuple):
  count: jax.Array
  sketches: Any


def _locate_path(path, dictionary):
  """Follow a jax tree path into a plain dict/list config."""
  carry = dictionary
  for p in path:
    if hasattr(p, "key"):
      carry = carry[p.key]
    elif hasattr(p, "idx"):
      carry = carry[p.idx]
    else:
      raise ValueError("no key or idx found")
  assert isinstance(carry, list), type(carry)
  return carry


def _axis_rank(options: Options, path, dim_index: int, d: int) -> int:
  if options.memory_alloc:
    return min(d, _locate_path(path, options.memory_alloc)[dim_index])
  return min(d, options.rank)


def _init(options: Options, params: optax.Params) -> _SketchyState:
  def _tensor_state(path, param) -> _TensorState:
    total = 1
    for d in param.shape:
      total *= d
    axes = []
    for i, d in enumerate(param.shape):
      if d == 1:
        raise ValueError(
            f"param {path} shape ({param.shape}) has unit dimensions")
      k = _axis_rank(options, path, i, d)
      m = min(d, k + (total // d if d else 0))
      axes.append(_AxisState(
          eigvecs=jnp.zeros((d, k)),
          eigvals=jnp.zeros((k,)),
          inv_eigvals=jnp.zeros((k,)),
          tail=jnp.zeros(()),
          inv_tail=jnp.zeros(()),
          ema_ggt=jnp.zeros((d, d)) if options.add_ggt else optax.MaskedNode(),
          svd_result_u=(jnp.zeros((d, m)) if options.ekfac_svd
                        else optax.MaskedNode()),
          svd_result_s=(jnp.zeros((m,)) if options.ekfac_svd
                        else optax.MaskedNode()),
          inv_prev_tail=(jnp.zeros(()) if options.ekfac_svd
                         else optax.MaskedNode()),
      ))
    return _TensorState(axes)

  return _SketchyState(
      count=jnp.zeros([], jnp.int32),
      sketches=jax.tree_util.tree_map_with_path(_tensor_state, params))


def _pspec(options: Options,
           params: praxis_shim.NestedHParams) -> praxis_shim.NestedHParams:
  count_spec = praxis_shim.WeightHParams(
      shape=[], init=None, dtype=jnp.int32, collections=None,
      tensor_split_dims_mapping=[])

  def _tensor_pspec(path, param):
    total = 1
    for d in param.shape:
      total *= d

    def _replicated(shape):
      return praxis_shim.WeightHParams(
          shape=list(shape), init=None, dtype=jnp.float32, collections=None,
          tensor_split_dims_mapping=[-1] * len(shape))

    def _axis(i, d):
      k = _axis_rank(options, path, i, d)
      m = min(d, k + (total // d if d else 0))
      return dict(
          eigvecs=_replicated((d, k)),
          eigvals=_replicated((k,)),
          inv_eigvals=_replicated((k,)),
          tail=_replicated(()),
          inv_tail=_replicated(()),
          ema_ggt=_replicated((d, d)) if options.add_ggt
          else optax.MaskedNode(),
          svd_result_u=_replicated((d, m)) if options.ekfac_svd
          else optax.MaskedNode(),
          svd_result_s=_replicated((m,)) if options.ekfac_svd
          else optax.MaskedNode(),
          inv_prev_tail=_replicated(()) if options.ekfac_svd
          else optax.MaskedNode(),
      )

    return dict(axes=[_axis(i, d) for i, d in enumerate(param.shape)])

  return dict(
      count=count_spec,
      sketches=jax.tree_util.tree_map_with_path(
          _tensor_pspec, params, is_leaf=lambda x: hasattr(x, "shape")))


def _safe_svd(x, d):
  """SVD returning (u, s); all-NaN on non-finite input instead of hanging."""
  svd = lambda y: jnp.linalg.svd(y, full_matrices=False)[:2]

  def _nan(y):
    m = min(y.shape)
    return (jnp.full((d, m), jnp.nan, jnp.float32),
            jnp.full((m,), jnp.nan, jnp.float32))

  return jax.lax.cond(jnp.isfinite(x).all(), svd, _nan, x)


def _linear_tail(axis_state: _AxisState, k: int, d: int):
  """Extrapolate escaped mass from the log-log eigenvalue decay slope."""
  num_points = (k + 1) // 2
  assert num_points > 0
  ranks = jnp.arange(1, num_points + 1)
  vals = axis_state.eigvals[:num_points]
  sample_cov = jnp.cov(ranks, vals)
  s_x, s_xy = sample_cov[0, 0], sample_cov[0, 1]
  slope = jax.lax.cond(s_x > 0, lambda: s_xy / (s_x**2), lambda: 0.0)
  intercept = jnp.mean(vals) - slope * jnp.mean(ranks)
  log_ranks = jnp.log(jnp.arange(k + 1, d + 1))
  fitted = slope * log_ranks + intercept
  return jnp.exp(jax.scipy.special.logsumexp(fitted * 2)) / (d - k)


def _update_axis(options: Options, dim: int, path, update,
                 axis_state: _AxisState,
                 update_sketches: bool = True) -> _AxisState:
  """One FD sketch-and-invert step for a single tensor axis."""
  d = update.shape[dim]
  k = _axis_rank(options, path, dim, d)
  assert axis_state.eigvecs.shape == (d, k)

  weighted_sketch = axis_state.eigvecs * axis_state.eigvals[None, :]
  other = [i for i in range(update.ndim) if i != dim]
  g_dm = update.transpose([dim] + other).reshape(d, -1)
  decay = jnp.sqrt(options.second_moment_decay)

  concat = jnp.concatenate([weighted_sketch * decay, g_dm], axis=1)
  # QR first: a mathematical no-op that keeps the SVD operand [d, d]-ish
  # (avoids SVD pathologies on wide matrices).
  reduced = jnp.linalg.qr(concat.T, mode="r").T
  u, s = _safe_svd(reduced, d)
  assert u.shape[0] == d and u.shape[1] >= k

  cutoff = jnp.maximum(s[k], 0.0) if k < s.shape[0] else 0.0
  top = jnp.maximum(s[:k], 0.0)
  deflated = jnp.sqrt(jnp.maximum(0.0, top - cutoff)) * jnp.sqrt(top + cutoff)
  if options.linear_approx_tail and d > k:
    tail = _linear_tail(axis_state, k, d)
    undeflated = jnp.square(top)
  else:
    tail = axis_state.tail * decay + cutoff**2
    # undeflated == deflated^2 + tail exactly; avoid the subtract/re-add.
    undeflated = jnp.square(top) + axis_state.tail * decay

  mask = deflated > 0
  eigvecs = u[:, :k] * mask
  alpha = jnp.asarray(-1.0 / (2 * update.ndim), jnp.float32)
  if options.relative_epsilon and options.epsilon > 0:
    eps = jnp.max(undeflated) * options.epsilon
  else:
    eps = options.epsilon
  inv_eigvals = jnp.where(mask, (undeflated + eps) ** alpha, 0.0)
  eigvals = deflated * mask
  inv_tail = jnp.where(tail > 0, (tail + eps) ** alpha, 0.0)

  if options.add_ggt:
    ema_ggt = (axis_state.ema_ggt * decay
               + g_dm.dot(g_dm.T) * (1 - decay))
  else:
    ema_ggt = axis_state.ema_ggt

  if options.ekfac_svd:
    # EKFAC keeps the full current SVD basis for preconditioning, using the
    # previous step's tail (sketch may be frozen between update_freq steps).
    prev_tail = axis_state.tail
    undeflated_ekfac = jnp.square(jnp.maximum(s, 0.0)) + prev_tail * decay
    svd_result_u = u
    svd_result_s = jnp.where(
        undeflated_ekfac > 0, (undeflated_ekfac + eps) ** alpha, 0.0)
    inv_prev_tail = axis_state.inv_tail
  else:
    svd_result_u = axis_state.svd_result_u
    svd_result_s = axis_state.svd_result_s
    inv_prev_tail = axis_state.inv_prev_tail

  res = _AxisState(eigvecs, eigvals, inv_eigvals, tail, inv_tail,
                   ema_ggt, svd_result_u, svd_result_s, inv_prev_tail)
  # When only the EKFAC preconditioner refreshes, the sketch stays frozen.
  return jax.lax.cond(
      update_sketches,
      lambda: res,
      lambda: res._replace(
          eigvecs=axis_state.eigvecs,
          eigvals=axis_state.eigvals,
          inv_eigvals=axis_state.inv_eigvals,
          tail=axis_state.tail,
          inv_tail=axis_state.inv_tail,
      ))


def _update_sketches(options: Options, path, update,
                     sketches: _TensorState,
                     update_sketches: bool = True) -> _TensorState:
  new_axes = []
  for dim, axis_state in enumerate(sketches.axes):
    with jax.named_scope(f"UpdateSketchDim{dim}"):
      new_axes.append(
          _update_axis(options, dim, path, update, axis_state,
                       update_sketches))
  return _TensorState(new_axes)


def _precondition(options: Options, path, update,
                  sketches: _TensorState) -> jax.Array:
  """Apply low-rank + tail-complement preconditioning per axis."""
  g = update
  shape = g.shape
  roll = tuple(range(1, g.ndim)) + (0,)
  ekfac = options.ekfac_svd
  for dim, axis_state in enumerate(sketches.axes):
    with jax.named_scope(f"SketchPreconditionDim{dim}"):
      d = shape[dim]
      assert g.shape[0] == d
      k = _axis_rank(options, path, dim, d)
      assert list(axis_state.eigvecs.shape) == [d, k]
      eigvecs = axis_state.svd_result_u if ekfac else axis_state.eigvecs
      basis = jnp.tensordot(g, eigvecs, axes=[[0], [0]])
      lowrank = jnp.tensordot(basis, eigvecs, axes=[[g.ndim - 1], [1]])
      g = jnp.transpose(g, axes=roll)
      complement = g - lowrank
      inv_eigvals = (axis_state.svd_result_s if ekfac
                     else axis_state.inv_eigvals)
      scaled = jnp.tensordot(basis * inv_eigvals, eigvecs,
                             axes=[[g.ndim - 1], [1]])
      inv_tail = (axis_state.inv_prev_tail if ekfac else axis_state.inv_tail)
      g = scaled + inv_tail * complement
  return g


def _update(
    options: Options,
    updates: optax.Updates,
    state: _SketchyState,
    params: Optional[optax.Params] = None,
):
  del params
  sketches = state.sketches
  is_tensor = lambda x: isinstance(x, _TensorState)
  should_update = (state.count % options.update_freq) == 0

  full_update = functools.partial(
      jax.tree_util.tree_map_with_path,
      functools.partial(_update_sketches, options),
      updates, sketches, is_leaf=is_tensor)

  if not options.ekfac_svd:
    new_sketches = jax.lax.cond(should_update, full_update, lambda: sketches)
  else:
    precond_only = functools.partial(
        jax.tree_util.tree_map_with_path,
        lambda p, u, s: _update_sketches(options, p, u, s, False),
        updates, sketches, is_leaf=is_tensor)
    new_sketches = jax.lax.cond(should_update, full_update, precond_only)

  new_updates = jax.tree_util.tree_map_with_path(
      functools.partial(_precondition, options),
      updates, new_sketches, is_leaf=is_tensor)
  return new_updates, _SketchyState(
      count=state.count + 1, sketches=new_sketches)


def apply(options: Options) -> praxis_shim.ShardedGradientTransformation:
  """Sketchy gradient transformation."""
  _validate(options)
  return praxis_shim.ShardedGradientTransformation(
      functools.partial(_init, options),
      functools.partial(_update, options),
      functools.partial(_pspec, options),
  )
