"""Memory-sharded Shampoo: optimizer state concatenated and sharded over a mesh.

For very large models the per-parameter Kronecker factors dominate optimizer
memory.  This mode concatenates every block's statistics into ONE global
``[N, m, m]`` array (and likewise the preconditioners) whose leading axis is
sharded across devices — ZeRO-style memory scaling with the root solves
computed where the shards live.  Behavioural parity with the reference's
pjit mode (`/root/reference/precondition/distributed_shampoo.py:2162-2583`),
including its trainer contract: ``init`` returns an `InitFnState` carrying
``(init_fn, pspec_fn, shape_and_dtype_fn)`` so the training harness can
build the sharded state buffers itself.

Update ordering (differs from the data-parallel mode, by upstream design):
gradients are transformed with the preconditioners from step entry, then the
fresh statistics are re-stacked, resharded to the solve layout, solved, and
error-gated into the global preconditioner array for the *next* step.
"""

from __future__ import annotations

import functools
from typing import Any, List, NamedTuple, Optional

import jax
from jax import lax
import jax.numpy as jnp
import numpy as np
import optax

from precondition_tpu.ops import pth_root
from precondition_tpu.ops.pth_root import RootMetrics
from precondition_tpu.utils import pytree
from precondition_tpu.utils import shapes as shape_utils
from precondition_tpu.utils.control import tree_lazy_cond

Array = jax.Array


@pytree.dataclass
class GlobalShardedParameterStats:
  """The concatenated, mesh-sharded half of the state."""

  statistics: Array        # [N, m, m]
  preconditioners: Array   # [N, m, m]
  exponents: Array         # [N]


@pytree.dataclass
class LocalShardedParameterStats:
  """Per-parameter state; sharding mirrors the parameter itself."""

  diagonal_statistics: Any
  diagonal_momentum: Array
  momentum: Array
  training_metrics: Any
  index_start: np.int32 = pytree.field(pytree_node=False)
  sizes: Any = pytree.field(pytree_node=False)


class ShardedShampooStats(NamedTuple):
  global_stats: Any
  local_stats: Any


class ShampooState(NamedTuple):
  count: Array
  stats: Any


class InitFnState(NamedTuple):
  init_fn: Any
  pspec_fn: Any
  shape_and_dtype_fn: Any


def make_sharded_fns(
    *,
    preconditioner_from_params,
    skip_preconditioning,
    transform_grad,
    update_statistics,
    solve_batched,
    graft_has_diag_stats,
    matrix_epsilon,
    exponent_override,
    statistics_partition_spec,
    preconditioner_partition_spec,
    num_devices_for_pjit,
    preconditioning_compute_steps,
    inverse_failure_threshold,
    generate_training_metrics,
    init_metrics,
    reuse_preconditioner=False,
    use_stacked,
):
  """Build (init_fn_state_factory, sharded_update_fn).

  All per-mode policy (grafting math, statistics EMA, the batched solver)
  is injected from `distributed_shampoo` so both modes share one
  implementation of the math.  ``use_stacked`` is the data-parallel mode's
  condition for its stacked per-axis layout; params that meet it are read
  from and written to the global arrays as whole ``[nb * axes, m, m]``
  chunks instead of one slot at a time.
  """

  def _param_layout(params_flat):
    """Static layout: per-param (index_start, sizes), global padded size.

    Global slots are assigned in order of ascending exponent so every
    exponent group is one contiguous slice of the ``[N, m, m]`` array —
    the solve then runs per group with a *static* exponent (mat_power
    unrolls; several-x faster than a traced-exponent batch).
    """
    per_param = []
    for param in params_flat:
      if skip_preconditioning(param):
        per_param.append(([], 0))
        continue
      pre = preconditioner_from_params(param)
      sizes = [s[0] for s in pre.shapes_for_preconditioners()]
      exp = (pre.exponent_for_preconditioner()
             if exponent_override == 0 else exponent_override)
      per_param.append((sizes, exp))

    order = sorted((i for i, (s, _) in enumerate(per_param) if s),
                   key=lambda i: per_param[i][1])
    layouts = [None] * len(params_flat)
    groups = []  # (exponent, start, count), contiguous, ascending exponent
    index = 0
    max_size = 0
    for i in order:
      sizes, exp = per_param[i]
      layouts[i] = (index, sizes)
      if groups and groups[-1][0] == exp:
        groups[-1] = (exp, groups[-1][1], groups[-1][2] + len(sizes))
      else:
        groups.append((exp, index, len(sizes)))
      index += len(sizes)
      max_size = max([max_size] + sizes)
    for i, (sizes, _) in enumerate(per_param):
      if not sizes:
        layouts[i] = (index, [])
    padded_n = index
    if num_devices_for_pjit:
      padded_n = -(-index // num_devices_for_pjit) * num_devices_for_pjit
    if padded_n > index and groups:
      # Padding slots (identity matrices) join the last group; any
      # exponent is exact on the identity.
      exp, start, count = groups[-1]
      groups[-1] = (exp, start, count + padded_n - index)
    return layouts, index, padded_n, max_size, groups

  def _slot_info(params_flat, layouts, n, padded_n):
    """Per-global-slot (size, exponent), honouring the sorted layout."""
    slot_sizes = [0] * padded_n
    slot_exps = [1] * padded_n
    for param, (index_start, sizes) in zip(params_flat, layouts):
      if not sizes:
        continue
      pre = preconditioner_from_params(param)
      exp = (pre.exponent_for_preconditioner()
             if exponent_override == 0 else exponent_override)
      for k, d in enumerate(sizes):
        slot_sizes[index_start + k] = d
        slot_exps[index_start + k] = exp
    return slot_sizes, slot_exps

  def sharded_init_fn(params):
    """Materialise the global + local state."""
    params_flat, treedef = jax.tree.flatten(params)
    layouts, n, padded_n, max_size, _ = _param_layout(params_flat)
    slot_sizes, slot_exps = _slot_info(params_flat, layouts, n, padded_n)

    local_stats_flat = []
    for param, (index_start, sizes) in zip(params_flat, layouts):
      diag = jnp.zeros_like(param) if graft_has_diag_stats else []
      local_stats_flat.append(LocalShardedParameterStats(
          diag,
          jnp.zeros_like(param),
          jnp.zeros_like(param),
          init_metrics(len(sizes), generate_training_metrics),
          np.int32(index_start),
          sizes,
      ))

    if padded_n:
      # Slot statistics start as `pad_square_matrix(eps * I_d)`: eps on the
      # first d diagonal entries, 1 on the padded ones (and everywhere on
      # batch-padding slots, d = 0); every slot's root starts as I.
      eye = jnp.eye(max_size, dtype=jnp.float32)
      on = np.arange(max_size)[None, :] < np.asarray(slot_sizes)[:, None]
      diag = np.where(on, np.float32(matrix_epsilon), np.float32(1.0))
      global_stats = GlobalShardedParameterStats(
          eye * jnp.asarray(diag)[:, None, :],
          jnp.broadcast_to(eye, (padded_n, max_size, max_size)),
          jnp.asarray(slot_exps, jnp.int32))
    else:
      global_stats = GlobalShardedParameterStats(
          jnp.zeros((0, 0, 0), jnp.float32),
          jnp.zeros((0, 0, 0), jnp.float32),
          jnp.zeros((0,), jnp.int32))
    local_stats = jax.tree.unflatten(treedef, local_stats_flat)
    return ShampooState(
        count=jnp.zeros([], jnp.int32),
        stats=ShardedShampooStats(global_stats, local_stats))

  def sharded_init_partition_spec_fn(params, params_partition_spec=None,
                                     partition_spec_for_statistics=None):
    """Partition specs matching `sharded_init_fn`'s layout."""
    if params_partition_spec is None:
      params_partition_spec = jax.tree.map(
          lambda _: jax.sharding.PartitionSpec(), params)
    if partition_spec_for_statistics is None:
      partition_spec_for_statistics = statistics_partition_spec
    params_flat, treedef = jax.tree.flatten(params)
    specs_flat = treedef.flatten_up_to(params_partition_spec)
    layouts, _, _, _, _ = _param_layout(params_flat)
    local = []
    for spec, (index_start, sizes) in zip(specs_flat, layouts):
      scalar = jax.sharding.PartitionSpec()
      metrics_spec = (jax.tree.map(
          lambda _: scalar, RootMetrics()) if generate_training_metrics
                      else optax.MaskedNode())
      local.append(LocalShardedParameterStats(
          spec if graft_has_diag_stats else [],
          spec, spec, metrics_spec,
          np.int32(index_start), sizes))
    scalar = jax.sharding.PartitionSpec()
    global_spec = GlobalShardedParameterStats(
        partition_spec_for_statistics or scalar,
        partition_spec_for_statistics or scalar,
        scalar)
    return ShampooState(
        count=scalar,
        stats=ShardedShampooStats(global_spec,
                                  jax.tree.unflatten(treedef, local)))

  def sharded_init_shape_and_dtype_fn(params):
    """[shape, dtype] tree matching `sharded_init_fn`'s layout."""
    params_flat, treedef = jax.tree.flatten(params)
    layouts, _, padded_n, max_size, _ = _param_layout(params_flat)
    local = []
    for param, (index_start, sizes) in zip(params_flat, layouts):
      shape_dtype = [list(param.shape), param.dtype]
      metrics = (jax.tree.map(
          lambda a: [list(np.repeat(a, len(sizes)).shape), a.dtype],
          RootMetrics()) if generate_training_metrics and sizes
                 else optax.MaskedNode())
      local.append(LocalShardedParameterStats(
          shape_dtype if graft_has_diag_stats else [],
          shape_dtype, shape_dtype, metrics,
          np.int32(index_start), sizes))
    global_shapes = GlobalShardedParameterStats(
        [[padded_n, max_size, max_size], jnp.float32],
        [[padded_n, max_size, max_size], jnp.float32],
        [[padded_n], jnp.int32])
    return ShampooState(
        count=[[], jnp.int32],
        stats=ShardedShampooStats(global_shapes,
                                  jax.tree.unflatten(treedef, local)))

  def _chunk_axes(param, sizes, max_size):
    """Preconditioned-axis count when the param's slots are whole chunks.

    A param qualifies when it has the data-parallel mode's stacked layout
    and every block fills a whole slot: its slots are then ``nb * axes``
    consecutive ``[m, m]`` matrices in (block, axis) order.  Returns None
    for params that keep per-slot slicing (ragged or padded blocks).
    """
    if not (use_stacked and sizes) or any(d != max_size for d in sizes):
      return None
    pre = preconditioner_from_params(param)
    return len(pre.stacked_shapes()) if pre.stacked_layout() else None

  def _slice_stats(global_stats, local_stat, axes):
    """Per-param statistics/preconditioners from the global arrays.

    Static slicing (index_start/sizes are python ints): one slice of the
    global array per param, its contiguous ``[start, start + count)``
    range, then split locally: per axis ``[nb, m, m]`` in the stacked
    layout, else one ``[d, d]`` crop per slot.  Each slice of a sharded
    array is a collective, so slicing thousands of blocks one by one is
    what this avoids.
    """
    start = int(local_stat.index_start)
    count = len(local_stat.sizes)

    def read(x):
      chunk = x[start:start + count]
      if axes:
        m = x.shape[-1]
        chunk = chunk.reshape(count // axes, axes, m, m)
        return [chunk[:, a] for a in range(axes)]
      return [chunk[i, :d, :d] for i, d in enumerate(local_stat.sizes)]

    return read(global_stats.statistics), read(global_stats.preconditioners)

  def _constrain(x, spec):
    if spec is None:
      return x
    return lax.with_sharding_constraint(x, spec)

  def sharded_update_fn(grads, state, params):
    params_flat, treedef = jax.tree.flatten(params)
    grads_flat = treedef.flatten_up_to(grads)
    global_stats = state.stats.global_stats
    local_stats_flat = treedef.flatten_up_to(state.stats.local_stats)
    max_size = global_stats.statistics.shape[-1] if (
        global_stats.statistics.ndim == 3) else 0
    layouts, n, padded_n, _, groups = _param_layout(params_flat)
    slot_sizes, _ = _slot_info(params_flat, layouts, n, padded_n)

    # 1) per-param statistics update + grad transform with current roots.
    new_local_flat = []
    updates_flat = []
    chunks = {}  # index_start -> [k, m, m] fresh statistics, k >= 1
    for grad, local_stat, param in zip(grads_flat, local_stats_flat,
                                       params_flat):
      axes = _chunk_axes(param, local_stat.sizes, max_size)
      stats, pre = _slice_stats(global_stats, local_stat, axes)
      param_state = _LocalAdapter(local_stat, stats, pre)
      param_state = update_statistics(grad, param_state, param, state.count)
      update, param_state = transform_grad(grad, param_state, param,
                                           state.count)
      updates_flat.append(update)
      new_local_flat.append(LocalShardedParameterStats(
          param_state.diagonal_statistics,
          param_state.diagonal_momentum,
          param_state.momentum,
          local_stat.training_metrics,
          local_stat.index_start,
          local_stat.sizes))
      if not local_stat.sizes:
        continue
      if axes:
        fresh = jnp.stack(param_state.statistics, axis=1)
        fresh = fresh.reshape((-1,) + fresh.shape[2:])
      else:
        fresh = jnp.stack([shape_utils.pad_square_matrix(s, max_size)
                           for s in param_state.statistics])
      chunks[int(local_stat.index_start)] = fresh

    updates = jax.tree.unflatten(treedef, updates_flat)

    if n == 0:
      return updates, ShampooState(
          count=state.count + 1,
          stats=ShardedShampooStats(
              global_stats, jax.tree.unflatten(treedef, new_local_flat)))

    # 2) restack + pad the global statistics array (slot order).
    parts = [chunks[start] for start in sorted(chunks)]
    if padded_n > n:
      parts.append(jnp.broadcast_to(jnp.eye(max_size, dtype=jnp.float32),
                                    (padded_n - n, max_size, max_size)))
    stacked = _constrain(jnp.concatenate(parts), statistics_partition_spec)
    pads = jnp.asarray(slot_sizes, jnp.int32)

    # 3) gated sharded solve, one static-exponent slice per group.
    perform_step = state.count % preconditioning_compute_steps == 0

    def solve():
      xs = _constrain(stacked, preconditioner_partition_spec)
      root_parts = []
      metric_parts = []
      for exp, start, count in groups:
        # Warm-start from the (already stacked, slot-aligned) previous
        # roots; quality is certified per matrix inside the kernel.
        prevs = (global_stats.preconditioners[start:start + count]
                 if reuse_preconditioner else None)
        r, met = solve_batched(
            xs[start:start + count], exp, pads[start:start + count],
            prevs)
        root_parts.append(r)
        metric_parts.append(met)
      roots = jnp.concatenate(root_parts, axis=0)
      metrics = jax.tree.map(
          lambda *ms: jnp.concatenate(ms, axis=0), *metric_parts)
      roots = _constrain(roots, preconditioner_partition_spec)
      roots = _constrain(roots, statistics_partition_spec)
      return roots, metrics

    if preconditioning_compute_steps == 1:
      roots, metrics = solve()
    else:
      init_metrics_tree = jax.tree.map(
          lambda x: jnp.full((stacked.shape[0],), x),
          RootMetrics(error=jnp.asarray(inverse_failure_threshold,
                                        jnp.float32)))
      roots, metrics = tree_lazy_cond(
          perform_step, solve, (stacked, init_metrics_tree))

    # 4) error-gated blend into the global preconditioners.
    errors = metrics.error
    failed = jnp.logical_or(jnp.isnan(errors),
                            errors >= inverse_failure_threshold)
    new_pre = jnp.where(failed[:, None, None],
                        global_stats.preconditioners, roots)

    # 5) write back metrics into local stats.
    final_local = []
    for local_stat in new_local_flat:
      if generate_training_metrics and local_stat.sizes:
        start = int(local_stat.index_start)
        count = len(local_stat.sizes)
        m = jax.tree.map(lambda x: x[start:start + count], metrics)
        if preconditioning_compute_steps != 1:
          m = tree_lazy_cond(perform_step, lambda mm=m: mm,
                             local_stat.training_metrics)
        local_stat = local_stat.replace(training_metrics=m)
      final_local.append(local_stat)

    new_global = GlobalShardedParameterStats(
        stacked, new_pre, global_stats.exponents)
    return updates, ShampooState(
        count=state.count + 1,
        stats=ShardedShampooStats(
            new_global, jax.tree.unflatten(treedef, final_local)))

  def init_fn_state(_):
    return InitFnState(
        init_fn=sharded_init_fn,
        pspec_fn=sharded_init_partition_spec_fn,
        shape_and_dtype_fn=sharded_init_shape_and_dtype_fn)

  return init_fn_state, sharded_update_fn


class _LocalAdapter:
  """Duck-typed ParameterStats view over local+sliced-global state.

  `update_statistics` / `transform_grad` from the data-parallel mode expect
  an object with these attributes and `_replace`; this adapter lets the
  sharded mode reuse them unchanged.
  """

  def __init__(self, local_stat, statistics, preconditioners):
    self.diagonal_statistics = local_stat.diagonal_statistics
    self.diagonal_momentum = local_stat.diagonal_momentum
    self.momentum = local_stat.momentum
    self.training_metrics = local_stat.training_metrics
    self.statistics = statistics
    self.preconditioners = preconditioners
    self.avg_grad = optax.MaskedNode()  # FD not supported in sharded mode

  def _replace(self, **kw):
    out = _LocalAdapter.__new__(_LocalAdapter)
    out.__dict__.update(self.__dict__)
    out.__dict__.update(kw)
    return out
