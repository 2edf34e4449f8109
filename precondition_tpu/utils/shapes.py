"""Static shape planning: dim merging, block partitioning, padding.

All decisions here are made from *static* shapes at optimizer-init time and
stored as plain Python/numpy metadata — nothing in this module ever runs
inside a traced computation except the pure reshape/split/concat ops it
emits.  This keeps XLA programs static-shaped and avoids the reference's pattern of rebuilding partitioning
objects inside every traced update
(`/root/reference/precondition/distributed_shampoo.py:1293-1437`).
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def merge_small_dims(shape: Sequence[int], max_dim: int) -> List[int]:
  """Collapse runs of small dimensions whose product stays within ``max_dim``.

  Examples (parity with `distributed_shampoo.py:1293-1321`)::

    [1, 2, 512, 1, 2048, 1, 3, 4] -> [1024, 2048, 12]   (max_dim=1024)
    [1, 2, 768, 1, 2048]          -> [2, 768, 2048]
    [1, 1, 1]                     -> [1]

  Fewer, larger axes mean fewer, larger Kronecker factors — larger matmuls
  and fewer inverse-root solves.
  """
  shape = list(shape)
  if shape and all(d == 1 for d in shape):
    return [1]
  out: List[int] = []
  acc = 1
  for d in shape:
    if acc * d <= max_dim:
      acc *= d
    else:
      if acc > 1:
        out.append(acc)
      acc = d
  if acc > 1:
    out.append(acc)
  return out


def pad_square_matrix(mat: Array, max_size: int) -> Array:
  """Pad ``M`` to ``[[M, 0], [0, I]]`` of size ``max_size``.

  The identity pad block keeps the matrix well-conditioned so padded and
  unpadded inverse roots agree on the principal block
  (`distributed_shampoo.py:1324-1350`).
  """
  rows, cols = mat.shape
  if rows != cols:
    raise ValueError(f"Must be square, got {rows}x{cols}")
  if cols > max_size:
    raise ValueError(f"Matrix size {cols} exceeds max_size {max_size}")
  if rows == max_size:
    return mat
  pad = max_size - rows
  out = jnp.zeros((max_size, max_size), dtype=mat.dtype)
  out = out.at[:rows, :cols].set(mat)
  return out.at[jnp.arange(rows, max_size), jnp.arange(rows, max_size)].set(1.0)


def pad_square_stack(stack: Array, max_size: int) -> Array:
  """Batched `pad_square_matrix`: ``[k, d, d] -> [k, max, max]``.

  Each member becomes ``[[M, 0], [0, I]]`` — one fused pad + diagonal set
  for the whole stack instead of ``k`` per-matrix pads.
  """
  k, rows, cols = stack.shape
  if rows != cols:
    raise ValueError(f"Must be square, got {rows}x{cols}")
  if cols > max_size:
    raise ValueError(f"Matrix size {cols} exceeds max_size {max_size}")
  if rows == max_size:
    return stack
  out = jnp.zeros((k, max_size, max_size), dtype=stack.dtype)
  out = out.at[:, :rows, :cols].set(stack)
  idx = jnp.arange(rows, max_size)
  return out.at[:, idx, idx].set(1.0)


def pad_vector(vec: Array, max_size: int) -> Array:
  """Pad a vector with trailing zeros to ``max_size``."""
  size = vec.shape[0]
  if size > max_size:
    raise ValueError(f"Vector size {size} exceeds max_size {max_size}")
  if size == max_size:
    return vec
  return jnp.concatenate([vec, jnp.zeros([max_size - size], dtype=vec.dtype)])


class BlockPartitioner:
  """Splits a tensor's large axes into blocks of at most ``block_size``.

  Split points are computed once from the static shape; `partition` /
  `merge_partitions` emit pure splits/concats.  The trailing block on each
  axis may be smaller than ``block_size`` (it is padded downstream, see
  `pad_square_matrix`).  Parity: `distributed_shampoo.py:1387-1437`.
  """

  def __init__(self, shape: Sequence[int], block_size: int):
    self._shape = tuple(shape)
    self._splits: List[Tuple[int, np.ndarray]] = []
    split_sizes: List[np.ndarray] = []
    for axis, d in enumerate(self._shape):
      if 0 < block_size < d:
        nsplit = (d - 1) // block_size
        indices = (np.arange(nsplit, dtype=np.int32) + 1) * block_size
        sizes = np.full(nsplit + 1, block_size, dtype=np.int32)
        sizes[-1] = d - indices[-1]
        self._splits.append((axis, indices))
        split_sizes.append(sizes)
      else:
        split_sizes.append(np.asarray([d], dtype=np.int32))
    self._split_sizes = split_sizes

  @property
  def shape(self) -> Tuple[int, ...]:
    return self._shape

  def split_sizes(self) -> List[np.ndarray]:
    """Per-axis arrays of block extents."""
    return self._split_sizes

  def num_blocks(self) -> int:
    n = 1
    for sizes in self._split_sizes:
      n *= len(sizes)
    return n

  def block_shapes(self) -> List[Tuple[int, ...]]:
    """Shapes of all blocks, in `partition` order (row-major over axes)."""
    return [tuple(int(s) for s in t)
            for t in itertools.product(*self._split_sizes)]

  def partition(self, tensor: Array) -> List[Array]:
    """Split into blocks; order is row-major over per-axis chunk indices."""
    assert tensor.shape == self._shape, (tensor.shape, self._shape)
    tensors = [tensor]
    for axis, indices in self._splits:
      tensors = [piece
                 for t in tensors
                 for piece in jnp.split(t, indices, axis=axis)]
    return tensors

  def uniform_block_shape(self) -> Tuple[int, ...] | None:
    """The common block shape, or None when trailing blocks are ragged."""
    shapes = self.block_shapes()
    return shapes[0] if all(s == shapes[0] for s in shapes) else None

  def partition_stacked(self, tensor: Array) -> Array:
    """All blocks as one ``[num_blocks, *block_shape]`` array.

    Uniform blocks only.  Implemented as reshape-transpose-reshape (3 HLO
    ops) instead of the O(num_blocks) split/stack chain `partition` emits
    — on a 712-block parameter tree that chain dominates program size
    and compile time.  Block order matches
    `partition` (row-major over per-axis chunk indices).
    """
    block = self.uniform_block_shape()
    assert block is not None, "ragged trailing blocks; use partition()"
    counts = [d // b for d, b in zip(self._shape, block)]
    interleaved = []
    for n, b in zip(counts, block):
      interleaved += [n, b]
    x = jnp.reshape(tensor, interleaved)
    ndim = len(self._shape)
    x = jnp.transpose(
        x, [2 * i for i in range(ndim)] + [2 * i + 1 for i in range(ndim)])
    return jnp.reshape(x, (int(np.prod(counts)),) + block)

  def merge_stacked(self, stacked: Array) -> Array:
    """Inverse of `partition_stacked`."""
    block = self.uniform_block_shape()
    assert block is not None
    counts = [d // b for d, b in zip(self._shape, block)]
    x = jnp.reshape(stacked, tuple(counts) + block)
    ndim = len(self._shape)
    perm = []
    for i in range(ndim):
      perm += [i, ndim + i]
    x = jnp.transpose(x, perm)
    return jnp.reshape(x, self._shape)

  def merge_partitions(self, partitions: Sequence[Array]) -> Array:
    """Inverse of `partition`."""
    partitions = list(partitions)
    for axis, indices in reversed(self._splits):
      n = len(indices) + 1
      partitions = [
          jnp.concatenate(partitions[i:i + n], axis=axis)
          for i in range(0, len(partitions), n)
      ]
    assert len(partitions) == 1
    return partitions[0]
