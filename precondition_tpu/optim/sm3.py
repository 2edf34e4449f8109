"""SM3: memory-efficient adaptive optimization via cover-set accumulators.

Anil, Gupta, Koren, Singer — https://arxiv.org/abs/1901.11150.

For a tensor of shape ``[d0, ..., dk]``, SM3 keeps one 1-D accumulator per
axis (``sum(d_i)`` memory instead of ``prod(d_i)``).  The effective
second-moment estimate for entry ``(i0..ik)`` is the *min* over its covering
accumulators; after the update, each accumulator is re-sketched as the *max*
of the dense statistic over the other axes.  Both the min-broadcast and the
max-reduce are cheap elementwise ops and fuse with the surrounding
elementwise work under XLA.

Behavioural parity with `/root/reference/precondition/sm3.py:28-168`,
including the int8-quantised momentum buffer.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from precondition_tpu.utils.quantization import QuantizedValue

Array = jax.Array


class ParameterStats(NamedTuple):
  """Per-parameter SM3 state."""
  diagonal_statistics: Any  # list of per-axis accumulators
  diagonal_momentum: QuantizedValue  # int8-quantised momentum


class SM3State(NamedTuple):
  count: Array
  stats: Any


def sm3(
    learning_rate,
    beta1: float = 0.9,
    beta2: float = 0.999,
    diagonal_epsilon: float = 1e-10,
    weight_decay: float = 0.0,
    normalize_grads: bool = False,
) -> optax.GradientTransformation:
  """Builds the SM3 optimizer as an optax GradientTransformation.

  Args:
    learning_rate: step size, or a schedule ``step -> lr``.
    beta1: momentum decay.
    beta2: second-moment decay (1.0 means pure accumulation, AdaGrad-style).
    diagonal_epsilon: added inside the rsqrt.
    weight_decay: L2 coupled weight decay applied to the momentum-smoothed
      update.
    normalize_grads: normalise each gradient tensor to unit norm first
      (useful for high-variance gradients).
  """

  def _quantize_momentum(m):
    return QuantizedValue.from_float_value(m, jnp.int8)

  def init_fn(params):
    def _init(param):
      accumulators = [jnp.zeros([d]) for d in param.shape]
      momentum = _quantize_momentum(jnp.zeros_like(param))
      return ParameterStats(accumulators, momentum)

    return SM3State(
        count=jnp.zeros([], jnp.int32), stats=jax.tree.map(_init, params))

  def _expand(acc, shape, axis):
    """Reshape a 1-D accumulator so it broadcasts along every other axis."""
    view = [1] * len(shape)
    view[axis] = shape[axis]
    return jnp.reshape(acc, view)

  def _second_moment(grad, stats: ParameterStats):
    """beta2 * min-over-cover + (1-beta2) * g^2, dense."""
    w = (1.0 - beta2) if beta2 != 1.0 else 1.0
    if grad.ndim < 2:
      cover = stats.diagonal_statistics[0]
    else:
      expanded = [
          _expand(stats.diagonal_statistics[i], grad.shape, i)
          for i in range(grad.ndim)
      ]
      cover = functools.reduce(jnp.minimum, expanded)
    return beta2 * cover + w * grad**2

  def _resketch(grad, dense_stats):
    """Collapse the dense statistic back to per-axis max accumulators."""
    if grad.ndim == 1:
      return [dense_stats]
    out = []
    for i in range(grad.ndim):
      other = tuple(a for a in range(grad.ndim) if a != i)
      out.append(jnp.max(dense_stats, axis=other))
    return out

  def update_fn(updates, state, params=None):
    if normalize_grads:
      updates = jax.tree.map(
          lambda g: g / (jnp.linalg.norm(g) + 1e-16), updates)

    stats = state.stats
    # `updates` leads each tree.map below, so the matching ParameterStats
    # subtree of `stats` is passed through whole.
    dense_stats = jax.tree.map(_second_moment, updates, stats)
    precond_grads = jax.tree.map(
        lambda g, s: g * jax.lax.rsqrt(s + diagonal_epsilon),
        updates, dense_stats)
    w1 = (1.0 - beta1) if beta1 != 1.0 else 1.0
    momentum = jax.tree.map(
        lambda pg, s: beta1 * s.diagonal_momentum.to_float() + w1 * pg,
        precond_grads, stats)
    new_accumulators = jax.tree.map(_resketch, updates, dense_stats)
    new_stats = jax.tree.map(
        lambda m, acc: ParameterStats(acc, _quantize_momentum(m)),
        momentum, new_accumulators)

    if weight_decay > 0.0 and params is not None:
      momentum = jax.tree.map(lambda m, p: m + weight_decay * p,
                              momentum, params)

    lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
    new_updates = jax.tree.map(lambda m: -lr * m, momentum)
    return new_updates, SM3State(count=state.count + 1, stats=new_stats)

  return optax.GradientTransformation(init_fn, update_fn)
