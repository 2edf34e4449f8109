"""Grafting: borrow a first-order optimizer's step size per layer.

Runs a cheap "norm" optimizer (SGD / RMSProp / Adafactor) alongside the
second-order "direction" update and rescales the direction to the norm
optimizer's magnitude (https://openreview.net/forum?id=FpKgG31Z_i9).  Before
``start_preconditioning_step`` the norm update is used outright.  Tensors
where preconditioning is skipped (rank <= 1 or any dim too large) are masked
out of the direction optimizer entirely.  Semantics parity with
`/root/reference/precondition/tearfree/grafting.py`.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from precondition_tpu.tearfree import praxis_shim
from precondition_tpu.utils import pytree


@enum.unique
class GraftingType(enum.Enum):
  NONE = "none"
  SGD = "sgd"
  RMSPROP = "rmsprop"
  ADAFACTOR = "adafactor"


@dataclasses.dataclass
class Options:
  """Grafting options.

  Attributes:
    grafting_type: which optimizer supplies the update norm.
    second_moment_decay: RMSProp/Adafactor second-moment decay; 1.0 makes
      RMSProp a running sum (AdaGrad); must be 0 for SGD/NONE.
    start_preconditioning_step: before this step the grafting update is used
      as-is.
    epsilon: rsqrt regulariser for RMSProp/Adafactor.
    skip_preconditioning_any_dim_gt: skip second-order for tensors with any
      dim above this.
    skip_preconditioning_rank1: skip second-order for rank<=1 tensors.
    min_dim_size_to_factor: (Adafactor) only factor axes at least this long.
    multiply_by_parameter_scale: (Adafactor) relative step sizing.
    clipping_threshold: (Adafactor) update clipping, >= 1.
  """

  grafting_type: GraftingType = GraftingType.RMSPROP
  second_moment_decay: float = 0.999
  start_preconditioning_step: int = 0
  epsilon: float = 1e-23
  skip_preconditioning_any_dim_gt: int = 4096
  skip_preconditioning_rank1: bool = True
  min_dim_size_to_factor: int = 128
  multiply_by_parameter_scale: float = True
  clipping_threshold: float = 1.0


def _validate(options: Options):
  if options.grafting_type in (GraftingType.RMSPROP, GraftingType.ADAFACTOR):
    if options.epsilon < 0:
      raise ValueError(f"epsilon ({options.epsilon}) should be non-negative")
  if options.grafting_type == GraftingType.RMSPROP:
    if not 0 < options.second_moment_decay <= 1.0:
      raise ValueError(
          f"second_moment_decay ({options.second_moment_decay}) not in "
          f"(0, 1] for graft ({options.grafting_type})")
  if options.grafting_type == GraftingType.ADAFACTOR:
    if not 0 < options.second_moment_decay < 1.0:
      raise ValueError(
          f"second_moment_decay ({options.second_moment_decay}) not in "
          f"(0, 1) for graft ({options.grafting_type})")
    if options.min_dim_size_to_factor <= 0:
      raise ValueError(
          f"min_dim_size_to_factor ({options.min_dim_size_to_factor}) "
          "should be positive")
    if options.clipping_threshold < 1:
      raise ValueError(
          f"clipping_threshold ({options.clipping_threshold}) should be >= 1")


@pytree.dataclass
class _GraftMask:
  """Sentinel replacing leaves excluded from preconditioning."""


def _masked(node: Any) -> bool:
  return isinstance(node, _GraftMask)


def _mask_skipped(options: Options, tree):
  def _maybe(x):
    if options.skip_preconditioning_rank1 and x.ndim <= 1:
      return _GraftMask()
    if any(s > options.skip_preconditioning_any_dim_gt for s in x.shape):
      return _GraftMask()
    return x

  return jax.tree.map(_maybe, tree)


def _sgd() -> praxis_shim.ShardedGradientTransformation:
  tx = optax.identity()
  return praxis_shim.ShardedGradientTransformation(
      tx.init, tx.update, optax.EmptyState)


class RMSPropAccumulator(NamedTuple):
  acc: optax.Updates


def _rmsprop(options: Options) -> praxis_shim.ShardedGradientTransformation:
  """RMSProp(/AdaGrad at decay 1.0) norm optimizer."""

  def init_fn(params):
    return RMSPropAccumulator(acc=jax.tree.map(jnp.zeros_like, params))

  def update_fn(updates, state, params=None):
    del params
    decay = options.second_moment_decay

    def ema(prev, g):
      g2 = jnp.square(g)
      return g2 + prev if decay == 1.0 else g2 * (1 - decay) + decay * prev

    new_state = RMSPropAccumulator(jax.tree.map(ema, state.acc, updates))
    new_updates = jax.tree.map(
        lambda g, acc: g * jax.lax.rsqrt(acc + options.epsilon),
        updates, new_state.acc)
    return new_updates, new_state

  def init_pspec(mdl_params):
    def _spec(hparams):
      s = copy.deepcopy(hparams)
      s.init = None
      return s

    return RMSPropAccumulator(acc=jax.tree.map(_spec, mdl_params))

  return praxis_shim.ShardedGradientTransformation(
      init_fn, update_fn, init_pspec)


def _adafactor(options: Options) -> praxis_shim.ShardedGradientTransformation:
  """Adafactor norm optimizer (optax-backed; sign flipped to ascent)."""
  tx = optax.chain(
      optax.adafactor(
          min_dim_size_to_factor=options.min_dim_size_to_factor,
          decay_rate=options.second_moment_decay,
          multiply_by_parameter_scale=options.multiply_by_parameter_scale,
          eps=options.epsilon,
          clipping_threshold=options.clipping_threshold),
      optax.scale(-1),
  )

  def _pspec(_):
    raise NotImplementedError("adafactor partition specs")

  return praxis_shim.ShardedGradientTransformation(tx.init, tx.update, _pspec)


class GraftingState(NamedTuple):
  count: jax.Array
  direction: optax.OptState
  norm: optax.OptState


def _graft_with(direction, norm,
                options: Options) -> praxis_shim.ShardedGradientTransformation:
  """Combine direction + norm transforms into the grafted update."""
  start = options.start_preconditioning_step
  mask = functools.partial(_mask_skipped, options)

  def init_fn(params):
    return GraftingState(
        count=jnp.zeros([], jnp.int32),
        direction=direction.init(mask(params)),
        norm=norm.init(params))

  def update_fn(updates, state, params=None):
    dir_updates, dir_state = direction.update(
        mask(updates), state.direction, mask(params))
    norm_updates, norm_state = norm.update(updates, state.norm, params)
    new_state = GraftingState(
        count=state.count + 1, direction=dir_state, norm=norm_state)

    def maybe_graft(norm_upd, dir_upd):
      if _masked(dir_upd):
        return norm_upd
      assert norm_upd.shape == dir_upd.shape
      dir_norm = jnp.linalg.norm(dir_upd)
      multiplier = jnp.where(
          dir_norm > 0.0, jnp.linalg.norm(norm_upd) / dir_norm, 0.0)
      return jnp.where(state.count >= start, dir_upd * multiplier, norm_upd)

    new_updates = jax.tree.map(
        maybe_graft, norm_updates, dir_updates, is_leaf=_masked)
    return new_updates, new_state

  def init_pspec(mdl_params):
    count_spec = praxis_shim.WeightHParams(
        shape=[], init=None, dtype=jnp.int32, collections=None,
        tensor_split_dims_mapping=[])
    return dict(
        count=count_spec,
        direction=direction.init_partition_spec(mdl_params),
        norm=norm.init_partition_spec(mdl_params))

  return praxis_shim.ShardedGradientTransformation(
      init_fn, update_fn, init_pspec)


def graft(
    options: Options,
    direction: praxis_shim.ShardedGradientTransformation,
) -> praxis_shim.ShardedGradientTransformation:
  """Wrap ``direction`` with the configured grafting optimizer."""
  _validate(options)
  if options.grafting_type == GraftingType.NONE:
    return direction
  if options.grafting_type == GraftingType.SGD:
    return _graft_with(direction, _sgd(), options)
  if options.grafting_type == GraftingType.RMSPROP:
    return _graft_with(direction, _rmsprop(options), options)
  if options.grafting_type == GraftingType.ADAFACTOR:
    return _graft_with(direction, _adafactor(options), options)
  raise NotImplementedError(options.grafting_type)
