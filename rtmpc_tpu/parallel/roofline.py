"""Roofline accounting for the batched ADMM rollout engine.

The reference has no performance model at all (its cost is "one Clarabel
solve per step", ``TrackingMPC.py:51-55``); the engine's cost is exactly
computable from the problem geometry, so the bench reports where the
measured throughput sits against the card's compute and memory roofs, and
which of the two bounds it.

Cost model (per ADMM iteration, per batch element; ``ops/qp.py:_admm_body``):

    rhs = sigma x - q + As'(rho z - y)     (B,m)x(m,n) matmul
    xt  = Kinv rhs                         (B,n)x(n,n)
    zt  = As xt                            (B,n)x(n,m)
    + elementwise over-relaxation/clip/dual update

Three GEMMs of 2*B*(2mn + n^2) FLOPs.  The least memory traffic keeps the
iterates on chip for the whole solve: device memory then carries only the
per-solve state, parameters and the problem matrices.

The roofline share is the least time the card could take (the larger of
FLOPs over the peak of the arithmetic the products run in and bytes over
the memory bandwidth) divided by the measured time.  Peaks come from one table keyed
by ``device_kind``; a device missing from it is an error.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["DevicePeaks", "PEAKS", "device_peaks", "solve_arithmetic",
           "admm_engine_model", "roofline_summary"]


class DevicePeaks(NamedTuple):
    name: str
    bf16_tflops: float        # dense tensor-core bf16, f32 accumulate
    tf32_tflops: float        # dense tensor-core TF32
    f32_tflops: float         # float32 outside the tensor cores
    hbm_gbps: float
    source: str


_H100_SXM = DevicePeaks(
    name="NVIDIA H100 SXM", bf16_tflops=989.0, tf32_tflops=495.0,
    f32_tflops=67.0, hbm_gbps=3350.0,
    source="NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense rates "
           "without sparsity, at the 700 W power limit")

# keyed by jax.Device.device_kind
PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def device_peaks(device) -> DevicePeaks:
    """Published peaks of ``device`` (a ``jax.Device`` or its
    ``device_kind`` string).  Raises ``KeyError`` for a device that is not
    in ``PEAKS``: a roofline share against a guessed peak is no number."""
    kind = getattr(device, "device_kind", device)
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def solve_arithmetic(solver: str, precision: str,
                     dtype: str = "float32") -> str:
    """The arithmetic the batched engine's products run in.

    "bf16x3" (three bf16 tensor-core passes) only for the fused kernel at
    "high" (``ops/qp_pallas.py``); "f32" (IEEE float32, outside the tensor
    cores) for the kernel at "highest" and for every XLA-lowered solver,
    whose products run at ``HIGHEST`` under either precision name
    (``ops/precision.py``)."""
    if str(dtype) != "float32":
        raise ValueError(f"no peak for a {dtype} engine")
    if precision not in ("high", "highest"):
        raise ValueError(f"unknown matmul precision {precision!r}")
    return "bf16x3" if solver == "pallas" and precision == "high" else "f32"


def _matmul_peak_tflops(peaks: DevicePeaks, arithmetic: str) -> float:
    if arithmetic == "f32":
        return peaks.f32_tflops
    if arithmetic == "bf16x3":
        return peaks.bf16_tflops / 3.0
    raise ValueError(f"unknown arithmetic {arithmetic!r}")


def admm_engine_model(n: int, m: int, ntheta: int, iters_total: int,
                      T: int, batch: int) -> dict:
    """FLOPs and least device-memory bytes of one full batched rollout
    (T protocol steps, ``iters_total`` ADMM iterations per step)."""
    mm_iter = 2 * batch * (2 * m * n + n * n)            # the GEMM triple
    # per solve: q/l/u parameter maps + final residuals
    mm_solve = 2 * batch * (n + 2 * m) * ntheta \
        + 2 * batch * (2 * m * n + n * n)
    flops = T * (iters_total * mm_iter + mm_solve)

    state_bytes = 4 * batch * (n + 2 * m)                # x, y, z (f32)
    param_bytes = 4 * batch * ntheta
    weights = 4 * (n * n + 2 * m * n)                    # Kinv + As (+As')
    bytes_min = T * (2 * state_bytes + param_bytes + weights)
    return {
        "n": n, "m": m, "ntheta": ntheta, "iters_total": iters_total,
        "T": T, "batch": batch,
        "flops": float(flops),
        "bytes_min": float(bytes_min),
    }


def roofline_summary(model: dict, wall_s: float, peaks: DevicePeaks,
                     arithmetic: str) -> dict:
    """Achieved rate and roofline share of a measured rollout.

    ``roofline_share`` = max(t_compute, t_memory) / ``wall_s`` with
    t_compute = FLOPs / peak of ``arithmetic`` (``solve_arithmetic``) and
    t_memory = least bytes / bandwidth; ``roofline_bound`` names the
    larger term."""
    peak = _matmul_peak_tflops(peaks, arithmetic)
    t_compute = model["flops"] / (peak * 1e12)
    t_memory = model["bytes_min"] / (peaks.hbm_gbps * 1e9)
    bound = "compute" if t_compute >= t_memory else "memory"
    return {
        "achieved_tflops": model["flops"] / wall_s / 1e12,
        "roofline_share": max(t_compute, t_memory) / wall_s,
        "roofline_bound": bound,
        "peaks": {"device": peaks.name, "matmul_tflops": peak,
                  "arithmetic": arithmetic, "hbm_gbps": peaks.hbm_gbps,
                  "source": peaks.source},
    }
