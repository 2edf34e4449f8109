"""Test configuration: CPU backend with 8 virtual devices.

Multi-device code paths (round-robin root sharding, mesh shardings,
collectives) are exercised for real on a forced 8-device CPU topology —
better than the reference's 1-device pmap smoke tests.
"""

import os
import sys

# Both variables must be set before jax is first imported.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
  os.environ["XLA_FLAGS"] = (
      _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

assert jax.local_device_count() >= 8, (
    "expected the virtual 8-device CPU topology; got "
    f"{jax.local_device_count()} devices")

# The upstream reference package doubles as a numerics oracle in some tests.
# It is mounted read-only; never write bytecode caches into it.
sys.dont_write_bytecode = True
_REFERENCE_PATH = "/root/reference"
if os.path.isdir(_REFERENCE_PATH) and _REFERENCE_PATH not in sys.path:
  sys.path.append(_REFERENCE_PATH)

import pytest  # noqa: E402


def has_reference() -> bool:
  try:
    import precondition  # noqa: F401
    return True
  except ImportError:
    return False


requires_reference = pytest.mark.skipif(
    not has_reference(), reason="upstream reference oracle not importable")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_executable_caches():
  """Drop compiled executables between test modules.

  JAX pins every compiled program for the life of the process; across
  the full suite (~hundreds of compiles, each mapping multiple
  executable regions) the process walks into the kernel's
  vm.max_map_count limit (default 65530) and XLA's LLVM backend aborts
  with 'Cannot allocate memory' DESPITE free RAM — observed as a
  SIGABRT inside an innocent test_shampoo compile at ~2/3 of the suite.
  Per-module clearing is nearly free here: tests build fresh optimizer
  closures, so cross-test executable reuse was almost nil anyway.
  """
  yield
  jax.clear_caches()
