"""SPMD training: transformer + Shampoo over a dp x tp device mesh.

Run anywhere (forces an 8-device CPU mesh by default):

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/spmd_transformer.py

On several GPUs, set SPMD_EXAMPLE_REAL_DEVICES=1: the same code shards over
the real mesh — params by megatron-style TP rules, the batch over ``data``,
and the stacked inverse-root solves over the whole mesh via the partition
specs passed to the optimizer (collectives inserted by XLA; no pmap, no
manual collectives).
"""

import os

# Default to an 8-virtual-device CPU mesh so the demo runs anywhere; set
# SPMD_EXAMPLE_REAL_DEVICES=1 on a multi-GPU host to use it instead.
_FORCE_CPU = not os.environ.get("SPMD_EXAMPLE_REAL_DEVICES")
if _FORCE_CPU:
  os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                             + " --xla_force_host_platform_device_count=8")
  os.environ["JAX_PLATFORMS"] = "cpu"

import jax
import jax.numpy as jnp
import numpy as np

from precondition_tpu import distributed_shampoo
from precondition_tpu.models import transformer
from precondition_tpu.parallel import mesh as mesh_lib
from precondition_tpu.train import loop


def main():
  n = jax.device_count()
  mesh = mesh_lib.make_mesh((n // 2, 2))  # (data=n/2, model=2)
  print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")

  cfg = transformer.TransformerConfig(
      vocab_size=512, d_model=128, n_heads=4, n_layers=2, d_ff=256,
      max_seq_len=64, dtype=jnp.float32)
  params = transformer.init_params(jax.random.PRNGKey(0), cfg)

  tx = distributed_shampoo(
      learning_rate=1e-3,
      block_size=128,
      start_preconditioning_step=2,
      # Shard the stacked [N, m, m] root solves across every chip in the
      # mesh; results all-gather back. The NamedSharding carries the mesh,
      # so the solve batch pads itself to a device multiple automatically.
      statistics_partition_spec=mesh_lib.sharding(mesh, ("data", "model")),
      preconditioner_partition_spec=mesh_lib.sharding(mesh,
                                                      ("data", "model")),
      generate_training_metrics=False,
  )

  rng = np.random.RandomState(0)
  batches = ({"tokens": jnp.asarray(rng.randint(0, 512, (16, 64)))}
             for _ in range(10))
  params, _, losses = loop.train(
      lambda p, b: transformer.loss_fn(p, b, cfg), tx, params, batches,
      mesh=mesh, param_rules=transformer.TP_RULES, log_every=2)
  print(f"first loss {float(losses[0]):.4f} -> last {float(losses[-1]):.4f}")


if __name__ == "__main__":
  main()
