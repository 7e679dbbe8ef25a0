"""What each float32 matmul precision computes on the GPU.

For every ``jax.lax.Precision`` and the 3-pass and TF32 algorithm presets,
compiles a set of float32 products for the card and prints their relative
error against float64 NumPy (max |C - C64| / max |C64|):

  matmul 1024       a 1024x1024x1024 product
  mat-vec 1024      a 1024x1024 matrix times one vector
  flagship Kinv     the flagship ADMM's stiff K^{-1} (rho_eq ~ 1e3 rows)
                    times one vector, unbatched, as the per-element
                    rollout applies it
  flagship batched  the same K^{-1} applied under vmap to 16384 vectors,
                    as the batched engine applies it

These are the numbers behind ``ops/precision.py``'s choice of ``HIGHEST``
for XLA-lowered products.  The card's name and power limit come first.

Usage: python tools/precision_probe.py
"""

import os
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_ROOT, os.path.join(_ROOT, "tools")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def precisions(jax):
    """Name -> the ``precision=`` argument of ``jnp.matmul``."""
    P, A = jax.lax.Precision, jax.lax.DotAlgorithmPreset
    return {"DEFAULT": P.DEFAULT, "HIGH": P.HIGH, "HIGHEST": P.HIGHEST,
            "BF16_BF16_F32_X3": A.BF16_BF16_F32_X3,
            "TF32_TF32_F32": A.TF32_TF32_F32}


def rel_err(c, c64) -> float:
    c = np.asarray(c, np.float64)
    return float(np.max(np.abs(c - c64)) / np.max(np.abs(c64)))


def cases(kinv, batch=16384, seed=0):
    """Name -> (a, b, vmapped): float32 operands of each product."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    a = rng.standard_normal((1024, 1024)).astype(f32)
    b = rng.standard_normal((1024, 1024)).astype(f32)
    v = rng.standard_normal(1024).astype(f32)
    r = rng.standard_normal(kinv.shape[0]).astype(f32)
    rb = rng.standard_normal((batch, kinv.shape[0])).astype(f32)
    k = np.asarray(kinv, f32)
    return {"matmul 1024": (a, b, False), "mat-vec 1024": (a, v, False),
            "flagship Kinv": (k, r, False),
            f"flagship batched ({batch})": (k, rb, True)}


def measure(jax, prec, a, b, vmapped) -> float:
    import jax.numpy as jnp
    if vmapped:
        f = jax.jit(jax.vmap(lambda x: jnp.matmul(a, x, precision=prec)))
        ref = np.einsum("ij,bj->bi", a.astype(np.float64),
                        b.astype(np.float64))
    else:
        f = jax.jit(lambda x: jnp.matmul(a, x, precision=prec))
        ref = a.astype(np.float64) @ b.astype(np.float64)
    return rel_err(f(b), ref)


def main() -> int:
    import jax
    import bench
    import parity_checks
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"precision_probe measures the GPU; JAX's default device is "
              f"{dev.platform!r}", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {bench.card_info()}")
    print(f"jax {jax.__version__}  device_kind {dev.device_kind}")
    arrays, _ = parity_checks.flagship_setup().to_device(
        **parity_checks.bench_solver_kw())
    work = cases(np.asarray(arrays.admm.Kinv))
    print(f"{'precision':<18}" + "".join(f"{n:>28}" for n in work))
    for name, prec in precisions(jax).items():
        row = []
        for a, b, vm in work.values():
            try:
                row.append(f"{measure(jax, prec, a, b, vm):>28.3e}")
            except (ValueError, NotImplementedError,
                    jax.errors.JaxRuntimeError) as e:  # backend refuses it
                row.append(f"{'refused: ' + type(e).__name__:>28}")
        print(f"{name:<18}" + "".join(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
