"""Process set-up shared by the GPU entry points (`chip_smoke.py`, `bench.py`).

Call these from a ``main()``, never at import: importing a module must not
configure JAX for whoever imported it.
"""

from __future__ import annotations

import os
import subprocess

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
  """Turns on JAX's persistent compilation cache; returns its directory.

  When ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and nothing
  is set here.  Otherwise the cache lives in ``.jax_cache`` at the root of
  this checkout, whatever the working directory.
  """
  env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
  if env:
    return env
  import jax

  path = os.path.join(_CHECKOUT, ".jax_cache")
  os.makedirs(path, exist_ok=True)
  jax.config.update("jax_compilation_cache_dir", path)
  return path


def gpu_name_and_power_limit() -> str:
  """``nvidia-smi``'s name and power limit of each card, one line per card.

  Run it before JAX first touches the card.  Exits non-zero when
  ``nvidia-smi`` is missing or fails: there is then no GPU to run on.
  """
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
  except (OSError, subprocess.SubprocessError) as e:
    raise SystemExit(f"no GPU: nvidia-smi failed: {e}") from e
  return out.stdout.strip()


def require_gpu():
  """JAX's devices; exits non-zero unless the first one is a GPU."""
  import jax

  devices = jax.devices()
  if devices[0].platform != "gpu":
    raise SystemExit(
        f"no GPU: JAX found platform {devices[0].platform!r}; this program "
        "measures and checks the GPU path only")
  return devices


def device_summary(devices) -> dict:
  """The device as JAX reports it, in the result line's format."""
  return {"platform": devices[0].platform, "kind": devices[0].device_kind,
          "count": len(devices)}
