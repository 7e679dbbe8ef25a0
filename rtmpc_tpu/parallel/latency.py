"""Per-step solve-latency measurement (the reference's methodology).

The reference wraps every Clarabel solve in wall-clock timing and reports a
histogram + max/95/90/75/median/mean over thousands of individual solves
(``results_linear_system.py:304-320``, ``TrackingMPC.py:51-55``).  The
batched engine amortizes thousands of QPs per dispatch, so an "average"
derived from batch throughput is NOT a per-step latency — it understates
what a deployed single-instance controller would see.

``measure_step_latencies`` reproduces the reference's measurement exactly:
one jitted single-step executable, called once per control tick with the
rollout state carried on-device between calls, wall-clock timed per call
(dispatch-inclusive, like the reference's ``time.time()`` pairs).
``device_step_time`` gives the complementary device-only number from a
chained scan (one dispatch, T steps, batch 1 — no batch amortization).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from .rollout import init_carry, make_rollout_fn

__all__ = ["measure_step_latencies", "device_step_time",
           "latency_report"]


def measure_step_latencies(arrays, cfg, refs, w, theta, gamma,
                           x0=None, warmup: int = 3, step_fn=None,
                           **rollout_kw):
    """Wall-clock per-step solve+protocol latencies [s] for a T-step
    closed loop, one dispatch per control tick (reference methodology).

    ``refs``/``w``: (T, nx); ``theta``/``gamma``: (T,).  Returns (T,)
    float64 seconds.  The rollout state (estimator, actuator, warm starts)
    is carried across calls exactly as in the scanned engine, so the
    trajectory equals the scan's — only the timing granularity differs.

    ``step_fn``: optionally a pre-jitted single-step rollout
    (``jax.jit(make_rollout_fn(arrays, cfg, 1))``) to share compilations
    with the caller.
    """
    T, nx = np.asarray(refs).shape
    dt = arrays.A.dtype
    if x0 is None:
        x0 = np.zeros(nx)
    step1 = (step_fn if step_fn is not None
             else jax.jit(make_rollout_fn(arrays, cfg, 1, **rollout_kw)))

    refs = jnp.asarray(refs, dt).reshape(T, 1, nx)
    w = jnp.asarray(w, dt).reshape(T, 1, nx)
    theta = jnp.asarray(theta, jnp.int32).reshape(T, 1)
    gamma = jnp.asarray(gamma, jnp.int32).reshape(T, 1)
    x0 = jnp.asarray(x0, dt)

    # NB: the estimator's sequence buffer must span the FULL experiment
    # horizon even though each dispatch advances one step
    carry = init_carry(arrays, cfg, x0, T)
    # warm-up: compile + populate caches
    for t in range(min(warmup, T)):
        c2, outs = step1(x0, refs[t], w[t], theta[t], gamma[t], carry)
        outs.x.block_until_ready()

    carry = init_carry(arrays, cfg, x0, T)
    times = np.empty(T)
    for t in range(T):
        t0 = time.perf_counter()
        carry, outs = step1(x0, refs[t], w[t], theta[t], gamma[t], carry)
        outs.x.block_until_ready()
        times[t] = time.perf_counter() - t0
    return times


def device_step_time(arrays, cfg, refs, w, theta, gamma, x0=None,
                     reps: int = 20, chain_fn=None, step_fn=None,
                     **rollout_kw):
    """Per-step DEVICE time [s]: a batch-1 T-step chained rollout in one
    dispatch, total wall time divided by T.  No batch amortization — the
    T steps execute sequentially (each consumes the previous estimator
    state), so this is the back-to-back step rate of one controller
    instance on a warm device; it excludes only the per-dispatch cost.
    Returns (per_step_seconds, dispatch_overhead_seconds_estimate).

    ``chain_fn``/``step_fn``: optional pre-jitted T-step / 1-step rollouts
    to share compilations with the caller."""
    T, nx = np.asarray(refs).shape
    dt = arrays.A.dtype
    if x0 is None:
        x0 = np.zeros(nx)
    fn = (chain_fn if chain_fn is not None
          else jax.jit(make_rollout_fn(arrays, cfg, T, **rollout_kw)))
    args = (jnp.asarray(x0, dt), jnp.asarray(refs, dt), jnp.asarray(w, dt),
            jnp.asarray(theta, jnp.int32), jnp.asarray(gamma, jnp.int32))
    fn(*args)[1].x.block_until_ready()
    seq = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)[1].x.block_until_ready()
        seq.append(time.perf_counter() - t0)
    total = float(np.median(seq))
    # one-step executable to estimate the fixed dispatch cost
    one = (step_fn if step_fn is not None
           else jax.jit(make_rollout_fn(arrays, cfg, 1, **rollout_kw)))
    a1 = (args[0], args[1][:1], args[2][:1], args[3][:1], args[4][:1])
    one(*a1)
    d = []
    for _ in range(reps):
        t0 = time.perf_counter()
        c, o = one(*a1)
        o.x.block_until_ready()
        d.append(time.perf_counter() - t0)
    dispatch = float(np.median(d))
    return max(total - dispatch, 0.0) / max(T - 1, 1), dispatch


def latency_report(times_s: np.ndarray, label: str = "",
                   budget_ms: Optional[float] = 20.0) -> dict:
    """The reference's quantile report (``results_linear_system.py:304-320``)
    over REAL per-solve measurements, plus its histogram counts
    (bins 2.5..20 ms, clipped, like ``:319``)."""
    ms = np.asarray(times_s, float) * 1e3
    stats = {
        "n_solves": int(ms.size),
        "max_ms": float(np.max(ms)),
        "p99_ms": float(np.quantile(ms, 0.99)),
        "p95_ms": float(np.quantile(ms, 0.95)),
        "p90_ms": float(np.quantile(ms, 0.90)),
        "p75_ms": float(np.quantile(ms, 0.75)),
        "median_ms": float(np.median(ms)),
        "mean_ms": float(np.mean(ms)),
    }
    # the reference's 2.5..20 ms bins (``results_linear_system.py:319``),
    # extended past the observed max so nothing clips into the last bin
    # (round-4 artifacts clipped 50-105 ms solves into "17.5-20", making
    # the stored histogram misrepresent the distribution)
    edges = np.arange(2.5, 20.0 + 2.5, 2.5)
    if ms.max() > edges[-1]:
        extra = np.arange(edges[-1] + 10.0, ms.max() + 10.0, 10.0)
        edges = np.concatenate([edges, extra])
    clipped = np.clip(ms, edges[0], edges[-1])
    hist, _ = np.histogram(clipped, bins=edges)
    stats["hist_bins_ms"] = edges.tolist()
    stats["hist_counts"] = hist.tolist()
    print(f"Solve-time stats{(' (' + label + ')') if label else ''} "
          f"over {stats['n_solves']} solves [ms]: "
          f"max={stats['max_ms']:.3f} p95={stats['p95_ms']:.3f} "
          f"p90={stats['p90_ms']:.3f} p75={stats['p75_ms']:.3f} "
          f"median={stats['median_ms']:.3f} mean={stats['mean_ms']:.3f}")
    if budget_ms is not None:
        ok = stats["p99_ms"] < budget_ms
        print(f"  p99 {stats['p99_ms']:.3f} ms vs {budget_ms:.0f} ms "
              f"real-time budget: {'within' if ok else 'EXCEEDS'}")
    return stats
