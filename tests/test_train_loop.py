"""train/loop.make_sharded_train_step on the virtual 8-device CPU mesh:
the state keeps its layout from step to step, so steps neither reshard nor
compile again."""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from precondition_tpu.models import transformer
from precondition_tpu.optim import shampoo
from precondition_tpu.parallel import mesh as mesh_lib
from precondition_tpu.train import loop as train_loop


def _setup():
  cfg = transformer.TransformerConfig(
      vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
      max_seq_len=16, remat=False)
  mesh = mesh_lib.make_mesh((2, 2), devices=jax.devices()[:4])
  solve = NamedSharding(mesh, P(("data", "model")))
  tx = shampoo.distributed_shampoo(
      learning_rate=0.01, block_size=16, start_preconditioning_step=0,
      graft_type=shampoo.GraftingType.RMSPROP, num_devices_for_pjit=4,
      statistics_partition_spec=solve, preconditioner_partition_spec=solve)
  params = mesh_lib.shard_params(
      transformer.init_params(jax.random.PRNGKey(0), cfg), mesh,
      transformer.TP_RULES)
  step = train_loop.make_sharded_train_step(
      lambda p, b: transformer.loss_fn(p, b, cfg), tx, mesh,
      transformer.TP_RULES)
  rng = np.random.RandomState(0)
  batches = [{"tokens": jnp.asarray(rng.randint(0, 64, (4, 17)), jnp.int32)}
             for _ in range(3)]
  return mesh, tx, params, step, batches


def _shardings(tree):
  return [x.sharding for x in jax.tree.leaves(tree)]


def test_state_comes_back_in_its_input_layout():
  mesh, tx, params, step, batches = _setup()
  # Eager init: leaves built from scratch (stacked statistics) are not
  # committed to devices; those built from params (momentum) are.
  opt_state = tx.init(params)
  committed = [x.committed for x in jax.tree.leaves(opt_state)]
  assert not all(committed) and any(committed)
  want = [x.sharding if x.committed else NamedSharding(mesh, P())
          for x in jax.tree.leaves((params, opt_state))]
  for batch in batches:
    _, params, opt_state = step(params, opt_state, batch)
    assert _shardings((params, opt_state)) == want


def test_steps_after_the_first_do_not_compile(caplog):
  _, tx, params, step, batches = _setup()
  opt_state = tx.init(params)
  _, params, opt_state = step(params, opt_state, batches[0])
  with jax.log_compiles(True), caplog.at_level(logging.WARNING):
    for batch in batches[1:]:
      loss, params, opt_state = step(params, opt_state, batch)
  assert np.isfinite(float(loss))
  compiles = [r.getMessage() for r in caplog.records
              if "Finished XLA compilation" in r.getMessage()]
  assert not compiles, compiles


def test_aot_compiled_step_takes_its_own_outputs():
  _, tx, params, step, batches = _setup()
  opt_state = jax.jit(tx.init)(params)
  compiled = step.lower(params, opt_state, batches[0]).compile()
  after_one = None
  for batch in batches:
    loss, params, opt_state = compiled(params, opt_state, batch)
    assert np.isfinite(float(loss))
    after_one = after_one or _shardings((params, opt_state))
    assert _shardings((params, opt_state)) == after_one
