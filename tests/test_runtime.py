"""The GPU entry points' process set-up, the pytree dataclass helper, and
the main path's imports."""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from precondition_tpu.utils import pytree
from precondition_tpu.utils import runtime

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_python(code, cwd, **env):
  full_env = {k: v for k, v in os.environ.items()
              if k != "JAX_COMPILATION_CACHE_DIR"}
  full_env.update(env, PYTHONPATH=_ROOT)
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=full_env, cwd=cwd)
  assert out.returncode == 0, out.stderr[-2000:]
  return out.stdout.split()


_CACHE_PROBE = (
    "import jax; from precondition_tpu.utils import runtime; "
    "print(runtime.enable_compile_cache(), "
    "jax.config.jax_compilation_cache_dir)")


class TestCompileCache:

  def test_env_dir_is_honoured_and_nothing_is_set(self, tmp_path):
    returned, configured = _run_python(
        _CACHE_PROBE, cwd=tmp_path,
        JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    assert returned == str(tmp_path / "cache")
    # jax reads the variable itself; the helper wrote nothing over it.
    assert configured == str(tmp_path / "cache")
    assert not os.path.exists(tmp_path / "cache")

  @pytest.mark.parametrize("where", ["root", "elsewhere"])
  def test_default_is_the_checkout_dir_whatever_the_cwd(self, tmp_path,
                                                        where):
    cwd = _ROOT if where == "root" else tmp_path
    returned, configured = _run_python(_CACHE_PROBE, cwd=cwd)
    assert returned == configured == os.path.join(_ROOT, ".jax_cache")


class TestDeviceChecks:

  def test_require_gpu_refuses_the_cpu(self):
    with pytest.raises(SystemExit, match="no GPU"):
      runtime.require_gpu()

  def test_missing_nvidia_smi_exits(self, monkeypatch):
    def missing(*args, **kwargs):
      raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(runtime.subprocess, "run", missing)
    with pytest.raises(SystemExit, match="nvidia-smi"):
      runtime.gpu_name_and_power_limit()

  def test_device_summary(self):
    assert runtime.device_summary(jax.devices()[:2]) == {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": 2}


@pytest.mark.parametrize("package", [
    "precondition_tpu", "precondition_tpu.tearfree",
    "precondition_tpu.train.loop"])
def test_main_path_imports_no_flax_pandas_or_orbax(package):
  # optax itself brings absl in (through chex), so absl only counts when
  # the package adds it.
  new = _run_python(
      "import sys, optax; before = set(sys.modules); "
      f"import {package}; "
      "print(' '.join(sorted({m.split('.')[0] for m in sys.modules} - "
      "{m.split('.')[0] for m in before})) or '-')", cwd=_ROOT)
  assert not {"flax", "absl", "pandas", "orbax"} & set(new), new


@pytree.dataclass
class _Point:
  x: jax.Array
  y: jax.Array = pytree.field(default_factory=lambda: jnp.zeros(2))
  name: str = pytree.field(pytree_node=False, default="p")


class TestPytreeDataclass:

  def test_replace_returns_an_updated_copy(self):
    p = _Point(jnp.ones(2))
    q = p.replace(x=jnp.full(2, 3.0), name="q")
    np.testing.assert_array_equal(p.x, 1.0)
    np.testing.assert_array_equal(q.x, 3.0)
    assert (p.name, q.name) == ("p", "q")
    with pytest.raises(dataclasses.FrozenInstanceError):
      p.x = q.x

  def test_flatten_round_trip_under_jit(self):
    p = _Point(jnp.arange(2.0), jnp.ones(2), name="static")
    leaves, treedef = jax.tree.flatten(p)
    back = jax.tree.unflatten(treedef, leaves)
    assert back.name == "static" and back.x is p.x and back.y is p.y
    out = jax.jit(lambda p: p.replace(x=p.x + p.y))(p)
    assert isinstance(out, _Point) and out.name == "static"
    np.testing.assert_array_equal(out.x, [1.0, 2.0])
    np.testing.assert_array_equal(jax.tree.map(lambda a: a * 2, p).y, 2.0)

  def test_static_fields_stay_out_of_the_leaves(self):
    a, b = _Point(jnp.ones(2), name="a"), _Point(jnp.ones(2), name="b")
    assert len(jax.tree.leaves(a)) == 2
    assert jax.tree.structure(a) != jax.tree.structure(b)
