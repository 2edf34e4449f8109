"""API-surface parity with google-research/precondition.

A user of the reference must be able to port configs unchanged
(MIGRATION.md contract).  These tests pin the *surface*: every reference
kwarg/Options field exists here with the same default.  Extra kwargs on our
side are allowed (they are additive features) but must be defaulted so
reference call-sites behave identically.

Skipped when the reference checkout is not mounted; the behavioral parity
is covered by the golden-fixture tests which are self-contained.
"""

import dataclasses
import inspect
import os
import sys

import pytest

_REF = "/root/reference"
pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(_REF, "precondition")),
    reason="reference checkout not mounted")

if os.path.isdir(_REF) and _REF not in sys.path:
  sys.path.append(_REF)


def _sig_parity(ref_fn, our_fn, ours_only_allowed=()):
  ref_params = inspect.signature(ref_fn).parameters
  our_params = inspect.signature(our_fn).parameters
  missing = set(ref_params) - set(our_params)
  assert not missing, f"reference kwargs absent here: {sorted(missing)}"
  extra = set(our_params) - set(ref_params) - set(ours_only_allowed)
  assert not extra, f"undeclared additive kwargs: {sorted(extra)}"
  for name, rp in ref_params.items():
    op = our_params[name]
    if rp.default is not inspect.Parameter.empty:
      assert op.default == rp.default or (
          # NaN-style/enum defaults compare by repr.
          repr(op.default) == repr(rp.default)
      ), f"default mismatch for {name}: ref={rp.default!r} ours={op.default!r}"
  for name in ours_only_allowed:
    if name in our_params:
      assert our_params[name].default is not inspect.Parameter.empty, (
          f"additive kwarg {name} must be defaulted")


def _fields_parity(ref_cls, our_cls, ours_only_allowed=()):
  """Every reference field exists here; our additive fields must be
  explicitly allowlisted AND defaulted (a reference config stays valid
  verbatim)."""
  rf = {f.name: f for f in dataclasses.fields(ref_cls)}
  of = {f.name: f for f in dataclasses.fields(our_cls)}
  extra = set(of) - set(rf)
  assert set(rf) <= set(of), sorted(set(rf) - set(of))
  assert extra <= set(ours_only_allowed), sorted(extra)
  for name in extra:
    f = of[name]
    assert (f.default is not dataclasses.MISSING
            or f.default_factory is not dataclasses.MISSING), (
                f"additive field {name} must be defaulted")


def test_distributed_shampoo_signature():
  from precondition import distributed_shampoo as ref
  from precondition_tpu.optim import shampoo as ours
  _sig_parity(
      ref.distributed_shampoo, ours.distributed_shampoo,
      ours_only_allowed=(
          "delayed_preconditioning", "generate_detailed_metrics"))


def test_grafting_and_preconditioner_enums():
  from precondition import distributed_shampoo as ref
  from precondition_tpu.optim import shampoo as ours
  for name in ref.GraftingType.__members__:
    assert name in ours.GraftingType.__members__, name
  for name in ref.PreconditionerType.__members__:
    assert name in ours.PreconditionerType.__members__, name


def test_sm3_signature():
  from precondition import sm3 as ref
  from precondition_tpu.optim import sm3 as ours
  _sig_parity(ref.sm3, ours.sm3)


def test_tearfree_signature_and_options():
  from precondition.tearfree import optimizer as ref_opt
  from precondition_tpu.tearfree import optimizer as our_opt
  _sig_parity(ref_opt.tearfree, our_opt.tearfree)
  from precondition.tearfree import (
      grafting as rg, momentum as rm, second_order as rso,
      shampoo as rsh, sketchy as rsk)
  from precondition_tpu.tearfree import (
      grafting as og, momentum as om, second_order as oso,
      shampoo as osh, sketchy as osk)
  _fields_parity(rsh.Options, osh.Options,
                 ours_only_allowed=("solver_backend",))
  _fields_parity(rsk.Options, osk.Options)
  _fields_parity(rg.Options, og.Options)
  _fields_parity(rm.Options, om.Options)
  _fields_parity(rso.Options, oso.Options)
  _fields_parity(ref_opt.TearfreeOptions, our_opt.TearfreeOptions)


def test_oco_hparams_and_algorithms():
  from precondition.oco import algorithms as ref
  from precondition_tpu.oco import algorithms as ours
  _fields_parity(ref.HParams, ours.HParams)
  for name in ref.Algorithm.__members__:
    assert name in ours.Algorithm.__members__, name


def test_quantized_value_fields():
  from precondition import quantization_utils as ref
  from precondition_tpu.utils import quantization as ours
  # Same constructor surface for state-dict compatibility.
  rf = set(inspect.signature(ref.QuantizedValue).parameters)
  of = set(inspect.signature(ours.QuantizedValue).parameters)
  assert rf <= of, sorted(rf - of)
