"""Quantized optimizer state: linear-bucket int8/int16 with per-column scales.

Halves (int16) or quarters (int8) the device-memory footprint of Shampoo statistics and
momentum.  Scheme (behavioural parity with
`/root/reference/precondition/quantization_utils.py:26-114`):

* per-column scale ``max_abs / num_buckets`` with 127 buckets for int8 and
  32767 for int16 (the most-negative code is never produced);
* round-to-nearest to avoid bias;
* optional diagonal extraction for PSD matrices — the diagonal carries most
  of a statistics matrix's dynamic range, so it is stored separately in full
  precision and the off-diagonal residue quantises much better;
* ``bfloat16`` and ``float32`` pass through unquantised.

XLA fuses the dequantise-multiply into the consuming op, so the quantised
path trades compute for memory.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from precondition_tpu.utils import pytree

Array = jax.Array


@pytree.dataclass
class QuantizedValue:
  """A tensor stored in quantised form plus the metadata to decode it."""

  quantized: Any
  diagonal: Any  # full-precision diagonal when extract_diagonal is set
  bucket_size: Any  # per-column scale
  quantized_dtype: jnp.dtype = pytree.field(pytree_node=False)
  extract_diagonal: bool = pytree.field(pytree_node=False)
  shape: Any = pytree.field(pytree_node=False)

  @classmethod
  def from_float_value(cls, fvalue, quantized_dtype, extract_diagonal=False):
    if isinstance(fvalue, list) and not fvalue:
      return QuantizedValue([], [], [], quantized_dtype, extract_diagonal, [])
    quantized, diagonal, bucket_size = cls.quantize(
        fvalue, quantized_dtype, extract_diagonal)
    return cls(quantized, diagonal, bucket_size, quantized_dtype,
               extract_diagonal, list(quantized.shape))

  @classmethod
  def quantize(cls, fvalue, quantized_dtype, extract_diagonal=False):
    """Returns ``(codes, diagonal, bucket_size)``."""
    if quantized_dtype == jnp.float32:
      return fvalue, [], []
    if quantized_dtype == jnp.bfloat16:
      return fvalue.astype(jnp.bfloat16), [], []

    float_dtype = fvalue.dtype
    if quantized_dtype == jnp.int8:
      num_buckets = jnp.array(127.0, dtype=float_dtype)
    elif quantized_dtype == jnp.int16:
      num_buckets = jnp.array(32767.0, dtype=float_dtype)
    else:
      raise ValueError(f"Quantized dtype {quantized_dtype} not supported.")

    if extract_diagonal and fvalue.ndim != 2:
      raise ValueError("extract_diagonal requires a 2-D (square) input.")
    if fvalue.ndim < 1:
      raise ValueError("Cannot quantize a 0-D value.")

    diagonal = []
    if extract_diagonal:
      diagonal = jnp.diag(fvalue)
      fvalue = fvalue - jnp.diag(diagonal)

    max_abs = jnp.max(jnp.abs(fvalue), axis=0)
    bucket_size = max_abs / num_buckets
    scale = bucket_size[jnp.newaxis, ...]
    safe_scale = jnp.where(scale > 0.0, scale, jnp.ones_like(scale))
    codes = jnp.round(fvalue / safe_scale)
    return codes.astype(quantized_dtype), diagonal, bucket_size

  def to_float(self):
    """Decode back to floating point."""
    if isinstance(self.quantized, list) and not self.quantized:
      return self.quantized
    if self.quantized_dtype == jnp.float32:
      return self.quantized
    if self.quantized_dtype == jnp.bfloat16:
      return self.quantized.astype(jnp.float32)
    val = self.quantized.astype(self.bucket_size.dtype) * (
        self.bucket_size[jnp.newaxis, ...])
    if self.extract_diagonal:
      val += jnp.diag(self.diagonal)
    return val
