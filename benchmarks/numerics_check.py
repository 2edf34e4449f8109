"""Numerics of the batched inverse p-th root solver, against host float64.

On a GPU, a float32 matmul may run in TF32 unless the program asks for
more, and the solver asks for ``Precision.HIGHEST``; the CPU's float32
matmuls are exact, so a precision-sensitive failure cannot show in the CPU
tests.  This script checks, on whatever device JAX runs on:

* the TRUE residual ``|H^p (A + r I) - I|`` of every root, recomputed on the
  host in float64 — independent of the solver's self-reported error, which
  an invariant-drift bug can fake (a retired mixed-precision scheme
  self-reported 1e-6 while emitting roots with residuals near 1e8),
* agreement with a float64 ``numpy.linalg.eigh`` root of the same
  ridge-regularized matrix across a condition-number ladder,
* warm starts stay certified (error <= tolerance, iterations ~1-2).

`chip_smoke.py` applies the same checks to the optimizer's own statistics.

Run:  python benchmarks/numerics_check.py
Exit code 0 = all checks pass.  Prints one summary JSON line.
"""

import json
import os
import sys

import numpy as np
import scipy.stats

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from precondition_tpu.ops import pth_root  # noqa: E402

RIDGE_EPSILON = 1e-6
FLOAT32_EPS = 1.2e-7


def conditioned_batch(rng, n, m, cond):
  """Symmetric PSD batch with exact condition number ``cond``."""
  mats = []
  for _ in range(n):
    q = scipy.stats.ortho_group.rvs(m, random_state=rng)
    e = np.logspace(0, np.log10(cond), m)
    mats.append((q * e) @ q.T)
  return jnp.asarray(np.stack(mats), jnp.float32)


def spread_batch(rng, n, m, conds=(1e2, 1e6)):
  """``n`` PSD members with condition numbers log-spaced over ``conds``,
  then one near-singular member that the solver must take up its ridge
  ladder: eigenvalues 1 down to 1e-12 and one at -3e-6, a rounding-sized
  negative below the base ridge (1e-6 of the top eigenvalue)."""
  spectra = [np.logspace(0, -np.log10(c), m)
             for c in np.logspace(np.log10(conds[0]), np.log10(conds[1]), n)]
  spectra.append(np.append(np.logspace(0, -12, m - 1), -3e-6))
  mats = []
  for e in spectra:
    q, _ = np.linalg.qr(rng.randn(m, m))
    mats.append((q * e) @ q.T)
  return jnp.asarray(np.stack(mats), jnp.float32)


def effective_ridge(metrics):
  """Per-member ridge the solver used, in float64.

  The relative ridge ``eps * lambda_max`` escalates x10 per retry of the
  ladder (``ridge * 10^(retries-1)``).
  """
  return (RIDGE_EPSILON
          * np.maximum(np.asarray(metrics.max_eigenvalue, np.float64), 1e-30)
          * 10.0 ** np.maximum(
              np.asarray(metrics.retries, np.float64) - 1.0, 0.0))


def regularized(stats, ridges):
  """Host float64 ``A + r I`` per member."""
  m = stats.shape[-1]
  return np.asarray(stats, np.float64) + ridges[:, None, None] * np.eye(m)


def true_residuals(roots, damped, p):
  """Per-member host float64 ``max |H^p D - I|``."""
  h = np.asarray(roots, np.float64)
  m = h.shape[-1]
  hp = np.broadcast_to(np.eye(m), h.shape).copy()
  q, k = h, p
  while k:
    if k % 2:
      hp = np.matmul(hp, q)
    k //= 2
    if k:
      q = np.matmul(q, q)
  return np.abs(np.matmul(hp, damped) - np.eye(m)).max(axis=(1, 2))


def eigh_roots(damped, p):
  """Host float64 ``D^{-1/p}`` and the condition number of each ``D``."""
  e, u = np.linalg.eigh(damped)
  e = np.maximum(e, np.finfo(np.float64).tiny)
  roots = np.einsum("nij,nj,nkj->nik", u, e ** (-1.0 / p), u)
  return roots, e[:, -1] / e[:, 0]


def residual_ceiling(cond, p):
  """float32 storage of H alone costs ~eps*p*cond; allow 100x headroom."""
  return np.maximum(100.0 * FLOAT32_EPS * p * cond, 1.0)


def compare_with_host(roots, stats, metrics, p):
  """Float64 checks of a solved batch; returns (summary dict, failures).

  Members whose regularized condition number is at most 1e6 must match the
  float64 eigh root to a relative Frobenius error of 1e-3; every member's
  true residual must stay under `residual_ceiling`.
  """
  damped = regularized(stats, effective_ridge(metrics))
  want, cond = eigh_roots(damped, p)
  got = np.asarray(roots, np.float64)
  rel = (np.linalg.norm(got - want, axis=(1, 2))
         / np.linalg.norm(want, axis=(1, 2)))
  resid = true_residuals(roots, damped, p)
  ceiling = residual_ceiling(cond, p)
  checked = cond <= 1e6
  failures = []
  if np.any(rel[checked] > 1e-3):
    failures.append(f"{int(np.sum(rel[checked] > 1e-3))} members (cond<=1e6) "
                    f"off the float64 root by > 1e-3: max {rel[checked].max()}")
  if np.any(resid > ceiling):
    failures.append(f"{int(np.sum(resid > ceiling))} members above the "
                    f"residual ceiling: max {resid.max()}")
  summary = {
      "members": int(len(cond)),
      "members_cond_le_1e6": int(checked.sum()),
      "cond_max": float(cond.max()),
      "rel_fro_err_max_cond_le_1e6": (float(rel[checked].max())
                                      if checked.any() else None),
      "rel_fro_err_max": float(rel.max()),
      "true_residual_max": float(resid.max()),
      "true_residual_over_ceiling_max": float((resid / ceiling).max()),
      "retries_max": float(np.max(np.asarray(metrics.retries))),
      "iterations_max": float(np.max(np.asarray(metrics.iterations))),
  }
  return summary, failures


def main():
  rng = np.random.RandomState(7)
  out = {"platform": jax.devices()[0].platform}
  failures = []
  p = 4
  pads = jnp.full((16,), 128, jnp.int32)
  solve = jax.jit(lambda s: pth_root.batched_inverse_pth_root(s, p, pads))

  for cond in [1e2, 1e4, 1e6]:
    stats = conditioned_batch(rng, 16, 128, cond)
    roots, met = solve(stats)
    summary, fails = compare_with_host(roots, stats, met, p)
    out[f"cond{cond:.0e}"] = summary
    failures += [f"cond {cond:.0e}: {f}" for f in fails]

  # Warm-start certificate on drifted statistics.
  stats = conditioned_batch(rng, 16, 128, 1e3)
  cold, _ = solve(stats)
  g = jax.random.normal(jax.random.PRNGKey(0), stats.shape) * 0.01
  drifted = 0.999 * stats + 0.001 * (g @ jnp.swapaxes(g, 1, 2))
  warm, met_w = jax.jit(
      lambda s, w: pth_root.batched_inverse_pth_root(s, p, pads, prevs=w))(
          drifted, cold)
  out["warm"] = {"err": float(jnp.max(met_w.error)),
                 "iters_mean": float(jnp.mean(met_w.iterations))}
  if float(jnp.max(met_w.error)) > 0.05:
    failures.append("warm solve error above failure threshold")
  if float(jnp.mean(met_w.iterations)) > 4:
    failures.append(
        "warm certificate not engaging (iterations ~cold): "
        f"{float(jnp.mean(met_w.iterations))}")

  out["failures"] = failures
  print(json.dumps(out))
  sys.exit(1 if failures else 0)


if __name__ == "__main__":
  main()
