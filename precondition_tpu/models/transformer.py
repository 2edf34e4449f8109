"""Decoder-only transformer LM.

The reference's end-to-end application trains Gemma-2B with pmap
(`/root/reference/precondition/datamix_gemma/training_loop.py`); this module
is the framework's own flagship: a from-scratch decoder LM written for
jit+Mesh SPMD — bfloat16 activations, f32 params/optimizer state,
explicit tensor-parallel sharding annotations, `lax` control flow only, and
`jax.checkpoint` on the blocks so activation memory trades against
recomputation.

Tensor-parallel layout (megatron-style):
  * qkv / mlp-in kernels shard their *output* feature axis on ``model``;
  * out-proj / mlp-out kernels shard their *input* feature axis on
    ``model`` — the row-parallel matmul emits one psum per block;
  * embeddings shard the vocab axis.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
  vocab_size: int = 32000
  d_model: int = 512
  n_heads: int = 8
  n_layers: int = 4
  d_ff: int = 2048
  max_seq_len: int = 1024
  dtype: Any = jnp.bfloat16
  remat: bool = True

  @property
  def head_dim(self) -> int:
    return self.d_model // self.n_heads


# Parameter sharding rules: (path regex, PartitionSpec).
TP_RULES = (
    (r"embed/table", P("model", None)),
    (r"attn/qkv", P(None, "model")),
    (r"attn/out", P("model", None)),
    (r"mlp/in_proj", P(None, "model")),
    (r"mlp/out_proj", P("model", None)),
    (r"unembed/kernel", P(None, "model")),
)


def init_params(rng: Array, cfg: TransformerConfig) -> Dict[str, Any]:
  """Initialise parameters (f32 master copies)."""
  keys = jax.random.split(rng, cfg.n_layers + 3)
  scale = lambda d: 1.0 / jnp.sqrt(d)

  def dense(key, d_in, d_out):
    return jax.random.normal(key, (d_in, d_out), jnp.float32) * scale(d_in)

  params: Dict[str, Any] = {
      "embed": {
          "table": jax.random.normal(
              keys[0], (cfg.vocab_size, cfg.d_model), jnp.float32) * 0.02,
      },
      "pos_embed": {
          "table": jax.random.normal(
              keys[1], (cfg.max_seq_len, cfg.d_model), jnp.float32) * 0.02,
      },
      "blocks": [],
      "final_norm": {"scale": jnp.ones((cfg.d_model,), jnp.float32)},
      "unembed": {"kernel": dense(keys[2], cfg.d_model, cfg.vocab_size)},
  }
  for i in range(cfg.n_layers):
    k1, k2, k3, k4 = jax.random.split(keys[3 + i], 4)
    params["blocks"].append({
        "attn_norm": {"scale": jnp.ones((cfg.d_model,), jnp.float32)},
        "attn": {
            "qkv": dense(k1, cfg.d_model, 3 * cfg.d_model),
            "out": dense(k2, cfg.d_model, cfg.d_model),
        },
        "mlp_norm": {"scale": jnp.ones((cfg.d_model,), jnp.float32)},
        "mlp": {
            "in_proj": dense(k3, cfg.d_model, cfg.d_ff),
            "out_proj": dense(k4, cfg.d_ff, cfg.d_model),
        },
    })
  return params


def _rms_norm(x: Array, scale: Array) -> Array:
  var = jnp.mean(jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True)
  return (x * lax.rsqrt(var + 1e-6).astype(x.dtype)) * scale.astype(x.dtype)


def _attention(params, x: Array, cfg: TransformerConfig) -> Array:
  b, t, d = x.shape
  qkv = jnp.einsum("btd,de->bte", x, params["qkv"].astype(x.dtype))
  qkv = qkv.reshape(b, t, 3, cfg.n_heads, cfg.head_dim)
  q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
  logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / jnp.sqrt(
      cfg.head_dim).astype(x.dtype)
  mask = jnp.tril(jnp.ones((t, t), jnp.bool_))
  logits = jnp.where(mask[None, None], logits, jnp.asarray(-1e9, x.dtype))
  probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(x.dtype)
  ctx = jnp.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, d)
  return jnp.einsum("btd,de->bte", ctx, params["out"].astype(x.dtype))


def _mlp(params, x: Array) -> Array:
  h = jnp.einsum("...d,df->...f", x, params["in_proj"].astype(x.dtype))
  h = jax.nn.gelu(h)
  return jnp.einsum("...f,fd->...d", h, params["out_proj"].astype(x.dtype))


def _block(params, x: Array, cfg: TransformerConfig) -> Array:
  x = x + _attention(params["attn"],
                     _rms_norm(x, params["attn_norm"]["scale"]), cfg)
  x = x + _mlp(params["mlp"], _rms_norm(x, params["mlp_norm"]["scale"]))
  return x


def forward(params, tokens: Array, cfg: TransformerConfig) -> Array:
  """``tokens [b, t] -> logits [b, t, vocab]`` (logits in f32)."""
  _, t = tokens.shape
  x = params["embed"]["table"][tokens].astype(cfg.dtype)
  x = x + params["pos_embed"]["table"][:t].astype(cfg.dtype)
  block = _block
  if cfg.remat:
    block = jax.checkpoint(_block, static_argnums=(2,))
  for bp in params["blocks"]:
    x = block(bp, x, cfg)
  x = _rms_norm(x, params["final_norm"]["scale"])
  logits = jnp.einsum("btd,dv->btv", x.astype(jnp.float32),
                      params["unembed"]["kernel"])
  return logits


def loss_fn(params, batch, cfg: TransformerConfig) -> Array:
  """Next-token cross entropy; ``batch = {'tokens': [b, t]}``.

  Optional batch keys: ``target_mask [b, t]`` restricts the loss to masked
  positions; ``factors [b]`` weights each example (used by the datamix
  importance-weighting batch generators).
  """
  tokens = batch["tokens"]
  logits = forward(params, tokens[:, :-1], cfg)
  targets = tokens[:, 1:]
  logp = jax.nn.log_softmax(logits, axis=-1)
  nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
  mask = batch.get("target_mask")
  if mask is not None:
    mask = mask[:, 1:].astype(nll.dtype)
  else:
    mask = jnp.ones_like(nll)
  factors = batch.get("factors")
  if factors is not None:
    mask = mask * factors[:, None].astype(nll.dtype)
  denom = jnp.maximum(jnp.sum(mask), 1.0)
  return jnp.sum(nll * mask) / denom


# ------------------------------------------------------------- decoding --
def init_cache(cfg: TransformerConfig, batch_size: int,
               max_len: Optional[int] = None):
  """Per-layer KV cache ``[b, max_len, heads, head_dim]``."""
  t = max_len or cfg.max_seq_len
  shape = (batch_size, t, cfg.n_heads, cfg.head_dim)
  return [{"k": jnp.zeros(shape, cfg.dtype), "v": jnp.zeros(shape, cfg.dtype)}
          for _ in range(cfg.n_layers)]


def _attention_decode(params, x, cache, pos, cfg: TransformerConfig):
  """Single-position attention against the KV cache; returns (out, cache)."""
  b = x.shape[0]
  qkv = jnp.einsum("bd,de->be", x, params["qkv"].astype(x.dtype))
  qkv = qkv.reshape(b, 3, cfg.n_heads, cfg.head_dim)
  q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
  cache = {
      "k": lax.dynamic_update_slice_in_dim(cache["k"], k[:, None], pos, axis=1),
      "v": lax.dynamic_update_slice_in_dim(cache["v"], v[:, None], pos, axis=1),
  }
  logits = jnp.einsum("bhd,bkhd->bhk", q, cache["k"]) / jnp.sqrt(
      cfg.head_dim).astype(x.dtype)
  t = cache["k"].shape[1]
  mask = jnp.arange(t)[None, None, :] <= pos
  logits = jnp.where(mask, logits, jnp.asarray(-1e9, x.dtype))
  probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1).astype(x.dtype)
  ctx = jnp.einsum("bhk,bkhd->bhd", probs, cache["v"]).reshape(b, -1)
  return jnp.einsum("bd,de->be", ctx, params["out"].astype(x.dtype)), cache


def decode_step(params, caches, tokens: Array, pos,
                cfg: TransformerConfig):
  """One autoregressive step: ``tokens [b]`` at position ``pos``.

  Returns ``(logits [b, vocab], caches)``.  The KV-cache layout keeps the
  sequence axis contiguous so the per-step dynamic_update_slice is a cheap
  in-place write under XLA.
  """
  x = params["embed"]["table"][tokens].astype(cfg.dtype)
  x = x + params["pos_embed"]["table"][pos].astype(cfg.dtype)
  new_caches = []
  for bp, cache in zip(params["blocks"], caches):
    attn_out, cache = _attention_decode(
        bp["attn"], _rms_norm(x, bp["attn_norm"]["scale"]), cache, pos, cfg)
    x = x + attn_out
    x = x + _mlp(bp["mlp"], _rms_norm(x, bp["mlp_norm"]["scale"]))
    new_caches.append(cache)
  x = _rms_norm(x, params["final_norm"]["scale"])
  logits = jnp.einsum("bd,dv->bv", x.astype(jnp.float32),
                      params["unembed"]["kernel"])
  return logits, new_caches
