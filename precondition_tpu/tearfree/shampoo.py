"""Blocked Shampoo with per-tensor batched statistics (tearfree variant).

Unlike the core optimizer (`precondition_tpu.optim.shampoo`), which keeps a
python list of per-block factors, this layer stores each tensor's blocks
*stacked*: per axis, one ``[N, B, B]`` array over all ``N`` blocks.  The
statistics contraction is a single vmapped tensordot and the inverse roots
are one batched eigh per axis — no per-block dispatch.  Semantics parity
with
`/root/reference/precondition/tearfree/shampoo.py`.

Constraints (enforced at init, parity with the reference's `_validate` /
`make_blocks`): no unit dimensions, at most two dimensions >= block_size,
large dimensions divisible by the block size.  The `reshaper` transform
upstream guarantees these for arbitrary parameter shapes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import string
from typing import Any, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import optax

from precondition_tpu.tearfree import praxis_shim


@dataclasses.dataclass
class Options:
  """Blocked-Shampoo options.

  Attributes:
    block_size: block edge for the block-diagonal covariance approximation.
    update_preconditioners_freq: steps between inverse-root refreshes.
    update_statistics_freq: steps between statistics updates.
    second_moment_decay: EMA decay for statistics (1.0 = running sum).
    solver_backend: how the batched inverse roots are computed.

      ``"eigh"`` (upstream-parity semantics) eigendecomposes and treats
      eigenvalues below ``1e-6 * lambda_max`` as exactly zero —
      pseudo-inverse-root behavior on rank-deficient early-training
      covariances.

      ``"newton"`` runs the batched coupled-Newton solver with
      distributed_shampoo-style ridge semantics: near-null directions get
      ``(w + 1e-6 * lambda_max)^{-1/p}`` rather than zero.  MEASURED to
      degrade early-training trajectories
      (`TEARFREE_BACKEND_TRAJ.json`: tail-loss gap 5.1x seed noise —
      the ridge root's ~eps^{-1/p} ~= 30x weighting of near-null
      directions amplifies unlearned-direction noise that eigh's
      zero-clip ignores).  Opt in only when the preconditioning interval
      or a late ``start_preconditioning_step`` keeps rank-deficient
      covariances out of the solve.

      ``"filtered"`` reproduces eigh's zero-clip with matmuls only: the
      same coupled-Newton ridge root composed with a matmul-only smooth
      spectral projector onto eigenvalues above ``1e-6 * lambda_max``
      (`ops.pth_root.batched_spectral_projector`, Newton–Schulz sign
      iteration).  Trajectory-parity gated: the same 800-step byte-LM
      experiment shows its tail-loss gap to eigh *within* the seed-noise
      band (`TEARFREE_BACKEND_TRAJ.json`, filtered rows).

      ``"auto"`` (default) resolves to ``"eigh"``.
  """

  block_size: int = 1024
  update_preconditioners_freq: int = 1
  update_statistics_freq: int = 1
  second_moment_decay: float = 0.999
  solver_backend: str = "auto"


def _validate(options: Options) -> None:
  if options.block_size <= 1:
    raise ValueError(f"block_size ({options.block_size}) must be >1")
  if options.update_preconditioners_freq <= 0:
    raise ValueError(
        f"update_preconditioners_freq "
        f"({options.update_preconditioners_freq}) must be positive")
  if options.update_statistics_freq <= 0:
    raise ValueError(
        f"update_statistics_freq ({options.update_statistics_freq}) "
        "must be positive")
  if not 0 <= options.second_moment_decay <= 1:
    raise ValueError(
        f"second_moment_decay ({options.second_moment_decay}) "
        "should be in [0, 1]")
  if options.solver_backend not in ("eigh", "newton", "filtered", "auto"):
    raise ValueError(
        f"solver_backend ({options.solver_backend!r}) must be one of "
        "'eigh', 'newton', 'filtered', 'auto'")


class _AxesBlocks(NamedTuple):
  """Stacked per-axis factors for one tensor.

  ``stats[i]`` and ``roots[i]`` are ``[N, B_i, B_i]`` where ``N`` is the
  total number of blocks and ``B_i = min(dim_i, block_size)``.
  """

  stats: list
  roots: list


class _ShampooState(NamedTuple):
  count: jax.Array
  blocks: Any


@dataclasses.dataclass(frozen=True)
class _BlocksMeta:
  """Static blocking facts for one tensor shape."""

  block_sizes: list        # per-axis B_i
  num_blocks: int          # N
  param_shape: list
  large_axes: list         # axes with dim >= block_size
  blocks_per_large_axis: list
  blocks_axis: int         # where N sits in the blocked layout
  large_block_size: int
  debug_name: str = ""


def _blocks_meta(options: Options, shape: Sequence[int],
                 debug: str = "") -> _BlocksMeta:
  bs = options.block_size
  large_axes = [i for i, d in enumerate(shape) if d >= bs]
  blocks_per = [shape[i] // bs for i in large_axes]
  return _BlocksMeta(
      block_sizes=[min(d, bs) for d in shape],
      num_blocks=math.prod(blocks_per) if blocks_per else 1,
      param_shape=list(shape),
      large_axes=large_axes,
      blocks_per_large_axis=blocks_per,
      blocks_axis=min(large_axes, default=0),
      large_block_size=bs,
      debug_name=debug,
  )


def _check_shape(path, shape, options: Options):
  if any(d == 1 for d in shape):
    raise ValueError(f"param {path} shape ({shape}) has unit dimensions")
  if sum(d >= options.block_size for d in shape) > 2:
    raise ValueError(
        f"param {path} shape ({shape}) has >2 large dims for block size "
        f"{options.block_size}")
  if any(d % options.block_size != 0 for d in shape
         if d >= options.block_size):
    raise ValueError(
        f"param {path} shape ({shape}) has large dims indivisible by "
        f"block size {options.block_size}")


def _blockify(x: jax.Array, meta: _BlocksMeta) -> jax.Array:
  """Fold all blocks into one leading-of-large-axes ``N`` axis.

  The blocked layout keeps every original axis in order (large axes now of
  length ``block_size``) and inserts a single ``N`` axis at
  ``meta.blocks_axis``.  With two large axes ``a < b`` the per-axis block
  counts are flattened row-major into ``N``.
  """
  assert list(x.shape) == meta.param_shape, (x.shape, meta.param_shape)
  if not meta.large_axes:
    return jnp.expand_dims(x, meta.blocks_axis)

  if len(meta.large_axes) == 1:
    a = meta.large_axes[0]
    n = meta.blocks_per_large_axis[0]
    shape = (list(x.shape[:a]) + [n, meta.large_block_size]
             + list(x.shape[a + 1:]))
    return x.reshape(shape)

  a, b = meta.large_axes
  na, nb = meta.blocks_per_large_axis
  bs = meta.large_block_size
  shape = (list(x.shape[:a]) + [na, bs] + list(x.shape[a + 1:b])
           + [nb, bs] + list(x.shape[b + 1:]))
  x = x.reshape(shape)
  # Move nb (at index b+1 after the insertion of na) to sit after na.
  nb_ix = b + 1
  perm = list(range(len(shape)))
  perm.pop(nb_ix)
  perm.insert(a + 1, nb_ix)
  x = jnp.transpose(x, perm)
  # Merge (na, nb) -> N.
  merged = (list(x.shape[:a]) + [na * nb, bs]
            + list(x.shape[a + 3:b + 2]) + [bs] + list(x.shape[b + 3:]))
  return x.reshape(merged)


def _deblockify(x: jax.Array, meta: _BlocksMeta) -> jax.Array:
  """Invert `_blockify`."""
  if not meta.large_axes:
    return jnp.squeeze(x, meta.blocks_axis)
  if len(meta.large_axes) == 1:
    return x.reshape(meta.param_shape)

  a, b = meta.large_axes
  na, nb = meta.blocks_per_large_axis
  # Split N back into (na, nb).
  shape = list(x.shape)
  split = shape[:a] + [na, nb] + shape[a + 1:]
  x = x.reshape(split)
  # Move nb back in front of its block axis (which now sits at b+2).
  perm = list(range(len(split)))
  perm.pop(a + 1)
  perm.insert(b + 1, a + 1)
  x = jnp.transpose(x, perm)
  return x.reshape(meta.param_shape)


def _ema(old, new, decay):
  if decay == 1.0:
    return old + new
  return old * decay + new * (1 - decay)


def _update_block_stats(decay, update, block: _AxesBlocks,
                        meta: _BlocksMeta) -> _AxesBlocks:
  """Batched Gram update over the blocks axis for every tensor axis."""
  new_stats = []
  with jax.named_scope("ShampooStats"):
    for axis, cov in enumerate(block.stats):
      other = [i for i in range(len(meta.param_shape)) if i != axis]
      dot_all = functools.partial(jnp.tensordot, axes=(other, other))
      gram = jax.vmap(dot_all, in_axes=meta.blocks_axis, out_axes=0)(
          update, update)
      new_stats.append(_ema(cov, gram, decay))
  return _AxesBlocks(stats=new_stats, roots=block.roots)


def _pth_inv_root(p: int, cov: jax.Array) -> jax.Array:
  """Batched eigh-based ``cov^{-1/p}`` with relative eigenvalue clipping."""
  eps = 1e-6
  w, v = jnp.linalg.eigh(cov)
  # Eigenvalues below eps * lambda_max are treated as exactly zero (the
  # covariance is rank-deficient early in training).
  mask = w <= eps * jnp.max(w, axis=-1, keepdims=True)
  half = jnp.where(mask, 1.0, w) ** (-0.5 / p)
  half = jnp.where(mask, 0.0, half)
  half_v = v * half[..., None, :]
  return jnp.einsum("...ik,...jk->...ij", half_v, half_v)


def _batched_max_evs(cov: jax.Array, pads: jax.Array) -> jax.Array:
  """Fleet-wide batched top eigenvalues (loose 1% relative exit).

  ``relative_floor=0``: early-training covariances have lambda_max << 1,
  where the ridge paths' usual max(|ev|, 1) exit floor returns after one
  iteration with a gross underestimate — harmless for a ridge, fatal for
  the filtered backend's clip threshold.
  """
  from precondition_tpu.ops import pth_root

  return jax.vmap(
      lambda s, dd: pth_root.power_iteration(
          s, padding_start=dd, error_tolerance=1e-2,
          relative_tolerance=True, relative_floor=0.0)[1])(cov, pads)


def _batched_ridge_root(p: int, cov: jax.Array, pads) -> jax.Array:
  """Batched ridge-regularized ``cov^{-1/p}`` (coupled Newton)."""
  from precondition_tpu.ops import pth_root

  roots, _ = pth_root.batched_inverse_pth_root(cov, p, pads)
  return roots


def _newton_inv_root(p: int, cov: jax.Array) -> jax.Array:
  """Batched coupled-Newton ``cov^{-1/p}`` (ridge-regularized semantics)."""
  n, d = cov.shape[0], cov.shape[-1]
  return _batched_ridge_root(p, cov, jnp.full((n,), d, jnp.int32))


def _filtered_inv_root(p: int, cov: jax.Array) -> jax.Array:
  """eigh null-space semantics from matmuls only.

  The eigh backend's distinguishing behaviour is the zero-clip: directions
  with eigenvalue ``<= 1e-6 * lambda_max`` contribute NOTHING to the
  preconditioned update, where the plain ridge root weights them
  ``~eps^{-1/p}`` (~30x the top-eigenvalue weight at p=4) — measured to
  degrade early-training trajectories (`TEARFREE_BACKEND_TRAJ.json`, the
  round-4 "diverge" verdict on the plain newton backend).  This backend
  reproduces the clip without an eigendecomposition:

    1. batched coupled-Newton ridge root ``R ~= (A + eps λmax I)^{-1/p}``;
    2. a matmul-only smooth spectral projector ``P ~= 1{eig(A) > eps
       λmax}`` (`pth_root.batched_spectral_projector`, Newton–Schulz sign
       iteration);
    3. ``P R P`` — P and R are both (limits of) polynomials in A, so they
       commute and the product zero-clips exactly the directions eigh
       drops, while kept directions keep the Newton root's value.

  Everything is batched ``[N, d, d]`` matmuls, with no per-matrix
  factorization.  Semantics target:
  `/root/reference/precondition/tearfree/shampoo.py:466-474`.
  """
  from precondition_tpu.ops import pth_root

  n, d = cov.shape[0], cov.shape[-1]
  pads = jnp.full((n,), d, jnp.int32)
  eps = 1e-6
  max_evs = _batched_max_evs(cov, pads)
  roots = _batched_ridge_root(p, cov, pads)
  proj = pth_root.batched_spectral_projector(cov, eps * max_evs)
  out = jnp.einsum("nij,njk,nkl->nil", proj, roots.astype(proj.dtype), proj)
  out = 0.5 * (out + jnp.swapaxes(out, 1, 2))
  # A zero covariance (step-0 state) has lambda_max == 0: eigh masks every
  # direction and returns 0; match that exactly rather than P R P's
  # (huge ridge root) x (half projector).
  return out * (max_evs > 0.0)[:, None, None]


_SOLVER_FNS = {
    "eigh": _pth_inv_root,
    "newton": _newton_inv_root,
    "filtered": _filtered_inv_root,
}


def _resolve_solver(solver: str) -> str:
  """Resolve ``"auto"`` to the exact eigh factorization."""
  return "eigh" if solver == "auto" else solver


def _update_block_precond(block: _AxesBlocks, meta: _BlocksMeta,
                          solver: str = "eigh") -> _AxesBlocks:
  p = len(meta.param_shape) * 2
  inv_root = _SOLVER_FNS[_resolve_solver(solver)]
  with jax.named_scope("PthInvRoot"):
    new_roots = [inv_root(p, s) for s in block.stats]
  return _AxesBlocks(stats=block.stats, roots=new_roots)


def _precondition_blocks(update, block: _AxesBlocks,
                         meta: _BlocksMeta) -> jax.Array:
  """One einsum applying all axis roots to the blocked gradient at once."""
  letters = iter(string.ascii_letters)
  n = next(letters)
  contract = [next(letters) for _ in meta.param_shape]
  out = [next(letters) for _ in meta.param_shape]
  in_sub = contract[:]
  in_sub.insert(meta.blocks_axis, n)
  out_sub = out[:]
  out_sub.insert(meta.blocks_axis, n)
  root_subs = [n + o + c for c, o in zip(contract, out)]
  formula = ",".join(["".join(in_sub)] + root_subs) + "->" + "".join(out_sub)
  with jax.named_scope("PreconditionShampoo"):
    return jnp.einsum(formula, update, *block.roots)


def _init(options: Options, params: optax.Params) -> _ShampooState:
  def make_blocks(path, param):
    _check_shape(jax.tree_util.keystr(path), param.shape, options)
    meta = _blocks_meta(options, param.shape, jax.tree_util.keystr(path))
    stats = [jnp.zeros((meta.num_blocks, d, d)) for d in meta.block_sizes]
    roots = [jnp.broadcast_to(jnp.eye(d), (meta.num_blocks, d, d))
             for d in meta.block_sizes]
    return _AxesBlocks(stats, roots)

  return _ShampooState(
      count=jnp.zeros([], jnp.int32),
      blocks=jax.tree_util.tree_map_with_path(make_blocks, params))


def _pspec(options: Options,
           params: praxis_shim.NestedHParams) -> praxis_shim.NestedHParams:
  count_spec = praxis_shim.WeightHParams(
      shape=[], init=None, dtype=jnp.int32, collections=None,
      tensor_split_dims_mapping=[])

  def make_spec(path, param):
    meta = _blocks_meta(options, param.shape, jax.tree_util.keystr(path))
    replicated = functools.partial(
        praxis_shim.WeightHParams,
        init=None, dtype=jnp.float32, collections=None,
        tensor_split_dims_mapping=[-1, -1, -1])
    stats = [replicated((meta.num_blocks, d, d)) for d in meta.block_sizes]
    return dict(stats=stats, roots=stats)

  return dict(
      count=count_spec,
      blocks=jax.tree_util.tree_map_with_path(
          make_spec, params, is_leaf=lambda x: hasattr(x, "shape")))


def _update(
    options: Options,
    updates: optax.Updates,
    state: _ShampooState,
    params: Optional[optax.Params] = None,
) -> tuple:
  del params
  meta = jax.tree_util.tree_map_with_path(
      lambda path, x: _blocks_meta(options, x.shape,
                                   jax.tree_util.keystr(path)), updates)
  is_block = lambda x: isinstance(x, _AxesBlocks)
  blocks = state.blocks
  blocked = jax.tree.map(_blockify, updates, meta)

  update_stats = functools.partial(
      jax.tree.map,
      functools.partial(_update_block_stats, options.second_moment_decay),
      blocked, blocks, meta, is_leaf=is_block)
  blocks = jax.lax.cond(
      state.count % options.update_statistics_freq == 0,
      update_stats, lambda: blocks)

  update_precond = functools.partial(
      jax.tree.map,
      functools.partial(_update_block_precond,
                        solver=options.solver_backend),
      blocks, meta, is_leaf=is_block)
  blocks = jax.lax.cond(
      state.count % options.update_preconditioners_freq == 0,
      update_precond, lambda: blocks)

  new_state = _ShampooState(count=state.count + 1, blocks=blocks)
  preconditioned = jax.tree.map(
      _precondition_blocks, blocked, blocks, meta, is_leaf=is_block)
  return jax.tree.map(_deblockify, preconditioned, meta), new_state


def apply(options: Options) -> praxis_shim.ShardedGradientTransformation:
  """Blocked-Shampoo gradient transformation."""
  _validate(options)
  return praxis_shim.ShardedGradientTransformation(
      functools.partial(_init, options),
      functools.partial(_update, options),
      functools.partial(_pspec, options),
  )
