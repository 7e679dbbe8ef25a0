"""Shared plumbing for the runnable apps."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

RESULTS_DIR = os.environ.get(
    "RTMPC_RESULTS_DIR",
    os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "results"))


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--platform", default=None,
                   help="jax platform override (e.g. 'cpu'); default uses "
                        "JAX's default device")
    p.add_argument("--quick", action="store_true",
                   help="shrink the workload for smoke runs")
    p.add_argument("--no-figures", action="store_true",
                   help="skip matplotlib figure generation")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "float64"],
                   help="engine dtype; default float64 on CPU, float32 on "
                        "an accelerator")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--solver", default=None,
                   choices=["ip", "ip_riccati", "ip_hybrid", "admm", "pallas"],
                   help="QP solver: default 'ip' on CPU (f64 "
                        "interior-point, Clarabel-class) and the app's "
                        "accelerator default otherwise; 'admm' is the "
                        "warm-started throughput mode, 'pallas' routes "
                        "batched sweeps through the fused ADMM kernel; "
                        "'ip_riccati' is the structured accuracy mode "
                        "(Riccati/arrowhead KKT, ~10x the dense IP's "
                        "speed at the same Mehrotra algebra), 'ip_hybrid' "
                        "its f32 path following + f64 polish")
    return p


def init_jax(args, accel_default_solver: str = "admm"):
    """Apply the platform override and turn on the persistent compilation
    cache BEFORE any computation.

    ``accel_default_solver``: what ``--solver`` defaults to on an
    accelerator backend (CPU always defaults to the f64 interior point).
    The cartpole Results apps pass an interior point: on their 4-D N=20
    geometry the ADMM plateaus at ~1e-2 residuals (ACCURACY.md), so
    reference-grade accuracy is the default there and ``--solver admm``
    the opt-in throughput mode.  f32 is the accelerator default dtype;
    the hybrid's f64 polish phase turns on x64.
    """
    import jax
    from ..utils.compile_cache import enable_compile_cache
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    enable_compile_cache()
    if args.dtype is None:
        args.dtype = ("float64" if jax.default_backend() == "cpu"
                      else "float32")
    if args.solver is None:
        args.solver = ("ip" if jax.default_backend() == "cpu"
                       else accel_default_solver)
    if args.dtype == "float64" or args.solver == "ip_hybrid":
        # the hybrid's f64 polish phase needs x64 even with an f32 engine
        jax.config.update("jax_enable_x64", True)
    return jax


def solver_kwargs(args, ip_iters: int = 30, admm_iters: int = 120):
    """``to_device`` solver arguments for the parsed app flags.

    The ADMM path runs the two-phase rho schedule (60+60, alpha=1.8,
    rho2=rho*0.2) validated on the card by tools/parity_checks.py.  Polish
    is off in f32 (the LU-based polish does not improve an f32 iterate and
    costs a batched LU per step) and on for the f64 CPU path, where it
    reaches 1e-8-class KKT residuals.  ``--solver ip`` is the accuracy
    mode (Clarabel-class on f64 CPU; Ruiz-scaled f32 on an accelerator).
    """
    if args.solver == "ip":
        return dict(solver="ip", ip_iters=ip_iters, polish=True)
    if args.solver == "ip_riccati":
        return dict(solver="ip_riccati", ip_iters=ip_iters)
    if args.solver == "ip_hybrid":
        # 25+12 without f64-side iterative refinement: closed-loop parity
        # vs the f64 oracle measured unchanged (0.00-0.72% RMS) at ~half
        # the f64 polish cost of the 25+20+IR config
        return dict(solver="ip_hybrid", ip_iters=max(ip_iters, 25),
                    ip_hybrid_iters=12)
    sched = dict(solver=args.solver, iters=admm_iters // 2,
                 iters2=admm_iters - admm_iters // 2, alpha=1.8,
                 rho2_scale=0.2)
    sched["polish"] = args.dtype == "float64"
    return sched


def check_tol(args) -> float:
    """Constraint/invariant check tolerance for the active solver mode.

    Accuracy mode (f64 interior point, the reference-parity path asserted
    in tests) holds invariants to 1e-6 like the reference's Clarabel at
    tol 1e-7; the f32 ADMM+polish throughput mode satisfies them to
    solver tolerance (~1e-3 absolute on unit-scale constraints)."""
    return 1e-6 if (args.solver in ("ip", "ip_riccati")
                    and args.dtype == "float64") else 2.5e-3


def savefig(fig, name: str, enabled: bool = True):
    if not enabled:
        return None
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, name)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    print(f"[figure] {path}")
    return path


def check(name: str, ok: bool, detail: str = "") -> bool:
    print(f"[{'PASS' if ok else 'FAIL'}] {name}" +
          (f" — {detail}" if detail else ""))
    return bool(ok)


def solvetime_hist_figure(stats_by_label: dict, name: str,
                          enabled: bool = True):
    """The reference's solve-time histogram figure (Fig. 3d,
    ``results_linear_system.py:397-404``; dual-histogram variant
    ``results_linear_system_with_extendedMPC.py:409-431``): per-step
    solve times clipped into the 2.5–20 ms bins.

    ``stats_by_label``: {arm label: ``latency_report`` stats dict}.
    """
    if not enabled:
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 4))
    n = max(len(stats_by_label), 1)
    for i, (label, st) in enumerate(stats_by_label.items()):
        edges = np.asarray(st["hist_bins_ms"], float)
        counts = np.asarray(st["hist_counts"], float)
        wbin = (edges[1] - edges[0]) / (n + 0.5)
        ax.bar(edges[:-1] + i * wbin, counts, width=wbin, align="edge",
               label=label)
    ax.set_xlabel("Computational time [ms] (clipped to 2.5-20 ms bins)")
    ax.set_ylabel("Occurrences")
    ax.set_title("Per-step solve time (dispatch-inclusive)")
    if len(stats_by_label) > 1:
        ax.legend()
    return savefig(fig, name, enabled)


def save_summary_json(path, payload: dict):
    """Record the app's headline rows machine-readably (evidence for
    cross-backend comparison by ``tools/release_gate.py``)."""
    if not path:
        return None
    import json

    def _default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        return str(o)

    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=_default)
    print(f"[json] {path}")
    return path


# solve-time reporting lives in rtmpc_tpu.parallel.latency: real per-step
# measurements (measure_step_latencies) + the reference's quantile/histogram
# report (latency_report) — no synthesized statistics.
