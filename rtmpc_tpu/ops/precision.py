"""Explicit matmul precision for the numerically sensitive device path.

The ADMM and interior-point KKT operators are deliberately stiff (equality
rows are weighted by ``rho_eq_scale ~ 1e3``), so a single-pass reduced
precision product poisons the iteration: with single-pass bf16 operands the
batched flagship rollout diverges (1e28 at step 1).  An accelerator's
*default* float32 matmul is such a product — on an H100 XLA lowers both
``Precision.DEFAULT`` and ``Precision.HIGH`` to TF32 (3.3e-4 max relative
error on a 1024-deep product) — and a batched mat-vec under ``vmap`` IS a
matmul, so every matmul on the solve/protocol path goes through ``mm``
with ``Precision.HIGHEST`` (IEEE float32 on the GPU, 1.4e-6 on that
product).

The solve-path precision NAME (``set_matmul_precision`` /
``RTMPC_MATMUL_PRECISION``) selects the arithmetic of the fused ADMM
kernel (``ops/qp_pallas.py``) and nothing else:

* ``"highest"`` (the default): IEEE float32 products.
* ``"high"``: the 3-pass bf16 product (hi*hi + hi*lo + lo*hi of the
  bf16-split operands, accumulated in float32), validated against the
  float64 protocol oracle by ``tools/parity_checks.py`` and shipped by
  ``bench.py``.

XLA-lowered products run at ``HIGHEST`` under both names.  The 3-pass
algorithm as XLA offers it (``DotAlgorithmPreset.BF16_BF16_F32_X3``) was
measured on an H100 (``tools/precision_probe.py`` has the product
errors): correct on matrix-matrix products (5e-6 on the product above)
but not in the rollout — the unbatched per-element flagship rollout
diverged to 1e28 with it, as single-pass bf16 does — and only 7% faster
than ``HIGHEST`` in the batched engine (21.6k vs 20.2k rollouts/s).  A
3-pass split spelled out in jnp was both slower (16.5k) and wrong
(trajectories 0.19 off the oracle).  Single-pass ``"default"`` is
rejected as a name.
"""

import contextlib
import os

import jax
import jax.numpy as jnp

__all__ = ["HIGHEST", "mm", "set_matmul_precision", "get_matmul_precision",
           "matmul_precision"]

HIGHEST = jax.lax.Precision.HIGHEST

_VALID = ("high", "highest")


def _resolve(name: str) -> str:
    key = str(name).lower()
    if key not in _VALID:
        raise ValueError(
            f"invalid matmul precision {name!r}: valid values are "
            f"{sorted(_VALID)} ('default'/single-pass bf16 is rejected — "
            "it diverges on the solve path, see module docstring)")
    return key


_PRECISION = _resolve(os.environ.get("RTMPC_MATMUL_PRECISION", "highest"))
_traced = False      # set once the precision has been read by a trace


def set_matmul_precision(name: str) -> None:
    """Set the solve-path matmul precision: "high" or "highest".

    Takes effect at trace time — call before jitting/compiling rollouts.
    The precision is baked into compiled functions; changing it afterwards
    only affects NEW traces (jit caches keyed on the same function/shapes
    keep the old precision), so a warning is emitted in that case.
    """
    global _PRECISION
    new = _resolve(name)
    if _traced and new != _PRECISION:
        import warnings
        warnings.warn(
            "set_matmul_precision() called after solve-path functions were "
            "already traced: existing jit caches keep the previous "
            "precision. Call jax.clear_caches() (or re-create the jitted "
            "functions) for the change to take effect.",
            RuntimeWarning, stacklevel=2)
    _PRECISION = new


@contextlib.contextmanager
def matmul_precision(name: str):
    """Solve-path precision for the functions traced inside the block."""
    global _PRECISION
    old, _PRECISION = _PRECISION, _resolve(name)
    try:
        yield
    finally:
        _PRECISION = old


def get_matmul_precision() -> str:
    """The solve-path precision name, as a trace reads it."""
    global _traced
    _traced = True
    return _PRECISION


def mm(a, b):
    """``a @ b`` in IEEE float32 (or wider) — never the single-pass
    default."""
    return jnp.matmul(a, b, precision=HIGHEST)
