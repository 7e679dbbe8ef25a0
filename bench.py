"""Benchmark: batched lossy-network closed-loop tube-MPC rollouts.

Measures the flagship configuration
(``Example_of_Tube_Tracking_MPC_Over_Lossy_Network``: double integrator,
N=10 horizon, X=+-8, U=+-1, W=+-0.1, 70% packet loss both directions,
T=120 steps, one tracking QP per step per rollout):

* ``rollouts_per_s``        — closed-loop lossy-network rollouts per second
* ``qp_solves_per_s``       — tracking-QP solves per second (rollouts/s * T)
* ``p99_step_ms``/``p50_step_ms`` — dispatch-inclusive single-step latency
                              (one host->device call per control tick, the
                              reference's own measurement methodology),
                              against the 20 ms real-time budget
* ``step_device_ms``         — per-step device time of a batch-1 chained
                              rollout (back-to-back steps on a warm device,
                              no batch amortization, no dispatch)
* ``batched_step_amortized_ms`` — whole batched T-step rollout / T (throughput
                              figure, NOT a deployable latency)

Prints ONE JSON line, with the device it ran on (platform, device_kind,
count, and the card's name and power limit from ``nvidia-smi``).

The default configuration is the one validated against the float64
protocol oracle by ``tools/parity_checks.py``; throughput numbers are only
quoted for trajectory-accurate settings.

Env knobs: BENCH_BATCH (default 16384), BENCH_T (120), BENCH_ITERS,
BENCH_ITERS2, BENCH_POLISH, BENCH_REPS (5), BENCH_DTYPE (float32),
BENCH_SOLVER (admm|pallas|ip), BENCH_PRECISION (high|highest),
BENCH_PROFILE (trace dir).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Two-phase rho schedule: phase 1 at the tuned rho drives the primal/active
# set, phase 2 at rho*0.2 converges the dual (tools/sweep_schedule.py).
# Polish stays off in f32: the LU-based polish does not improve an f32
# iterate and costs a batched LU per step.
DEFAULT_ITERS = 60
DEFAULT_ITERS2 = 60
DEFAULT_RHO2_SCALE = 0.2
DEFAULT_ALPHA = 1.8
DEFAULT_POLISH = 0
DEFAULT_EARLY_TOL = None   # a vmapped while_loop runs at the slowest
                           # lane's pace; see tools/sweep_early_exit.py
# "high": the fused kernel's 3-pass bf16 products (XLA-lowered products
# run IEEE f32 under either name, ops/precision.py), validated against the
# f64 oracle by tools/parity_checks.py; BENCH_PRECISION=highest for IEEE
# f32 in the kernel too
DEFAULT_PRECISION = "high"


def card_info() -> str:
    """``name, power.limit`` of the visible cards from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


def main():
    import jax
    from rtmpc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's default device is "
                 f"{dev.platform!r}")
    import jax.numpy as jnp
    from rtmpc_tpu.utils import box
    from rtmpc_tpu.models import setup_tube_tracking
    from rtmpc_tpu.protocol import draw_loss_masks, draw_disturbances
    from rtmpc_tpu.parallel import make_batched_rollout
    from rtmpc_tpu.parallel.rollout import make_rollout_fn
    from rtmpc_tpu.parallel.latency import (device_step_time,
                                            measure_step_latencies)

    from rtmpc_tpu.ops.precision import (get_matmul_precision,
                                         set_matmul_precision)
    set_matmul_precision(os.environ.get("BENCH_PRECISION",
                                        DEFAULT_PRECISION))

    BATCH = int(os.environ.get("BENCH_BATCH", 16384))
    T = int(os.environ.get("BENCH_T", 120))
    ITERS = int(os.environ.get("BENCH_ITERS", DEFAULT_ITERS))
    ITERS2 = int(os.environ.get("BENCH_ITERS2", DEFAULT_ITERS2))
    ALPHA = float(os.environ.get("BENCH_ALPHA", DEFAULT_ALPHA))
    RHO2_SCALE = float(os.environ.get("BENCH_RHO2_SCALE",
                                      DEFAULT_RHO2_SCALE))
    REPS = int(os.environ.get("BENCH_REPS", 5))
    POLISH = bool(int(os.environ.get("BENCH_POLISH", str(DEFAULT_POLISH))))
    SOLVER = os.environ.get("BENCH_SOLVER", "admm")
    # BENCH_LATENCY=0 skips the batch-1 latency measurements
    LATENCY = bool(int(os.environ.get("BENCH_LATENCY", "1")))
    # residual-based early exit: "none" disables; default per DEFAULT_EARLY_TOL
    _et = os.environ.get("BENCH_EARLY_TOL", str(DEFAULT_EARLY_TOL))
    EARLY_TOL = None if _et in ("none", "None", "") else float(_et)
    dtype = jnp.dtype(os.environ.get("BENCH_DTYPE", "float32"))

    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0], [1.0]])
    setup = setup_tube_tracking(
        A, B, np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)
    arrays, cfg = setup.to_device(dtype=dtype, iters=ITERS, iters2=ITERS2,
                                  alpha=ALPHA, rho2_scale=RHO2_SCALE,
                                  polish=POLISH,
                                  solver=SOLVER, early_tol=EARLY_TOL)
    nx = cfg.nx

    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    theta, gamma = draw_loss_masks(k1, T, 0.7, 0.7, batch_shape=(BATCH,))
    w = draw_disturbances(k2, T, -0.1 * np.ones(nx), 0.1 * np.ones(nx),
                          batch_shape=(BATCH,)).astype(dtype)
    refs_np = np.zeros((T, nx), dtype=np.float64)
    refs_np[: T // 4, 0] = 5.0
    refs_np[T // 4: T // 2, 0] = -9.0
    refs_np[T // 2:, 0] = 4.0
    refs = jnp.broadcast_to(jnp.asarray(refs_np, dtype), (BATCH, T, nx))
    x0 = jnp.zeros((BATCH, nx), dtype)

    rollout = jax.jit(make_batched_rollout(arrays, cfg, T))

    # shard the rollout batch over every visible device (pure data
    # parallelism over scenarios — SURVEY.md section 2.4); jit partitions
    # the vmapped computation automatically from the input shardings
    n_dev = len(jax.devices())
    if n_dev > 1 and BATCH % n_dev == 0 and SOLVER != "pallas":
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        mesh = Mesh(np.array(jax.devices()), axis_names=("dp",))
        sh = NamedSharding(mesh, P("dp"))
        x0, refs, w, theta, gamma = (
            jax.device_put(a, sh) for a in (x0, refs, w, theta, gamma))

    # warm-up / compile
    t0 = time.perf_counter()
    carry, outs = rollout(x0, refs, w, theta, gamma)
    outs.x.block_until_ready()
    compile_s = time.perf_counter() - t0
    feasible_frac = float(jnp.mean(carry.feasible.astype(jnp.float32)))

    if os.environ.get("BENCH_PROFILE"):
        with jax.profiler.trace(os.environ["BENCH_PROFILE"]):
            rollout(x0, refs, w, theta, gamma)[1].x.block_until_ready()

    t0 = time.perf_counter()
    for _ in range(REPS):
        carry, outs = rollout(x0, refs, w, theta, gamma)
    outs.x.block_until_ready()
    dt_total = (time.perf_counter() - t0) / REPS

    rollouts_per_s = BATCH / dt_total
    qp_solves_per_s = rollouts_per_s * T

    # --- roofline share (model FLOPs/bytes + measured wall time) ---------
    from rtmpc_tpu.parallel.roofline import (admm_engine_model,
                                             device_peaks, roofline_summary,
                                             solve_arithmetic)
    n_p = int(arrays.admm.Kinv.shape[0])
    m_p = int(arrays.admm.As.shape[0])
    ntheta = int(arrays.admm.Mq.shape[1])
    # per device: the batch is split evenly over the visible devices
    model = admm_engine_model(n_p, m_p, ntheta, ITERS + ITERS2, T,
                              BATCH // n_dev)
    try:
        roof = roofline_summary(
            model, dt_total, device_peaks(dev),
            solve_arithmetic(SOLVER, get_matmul_precision(), dtype))
    except (KeyError, ValueError) as e:
        roof = {"roofline_share": f"not measured ({e})"}

    # --- latency of one controller instance, batch 1 ----------------------
    lat = {}
    if LATENCY:
        refs1 = np.asarray(refs_np)
        w1 = np.asarray(w[0])
        th1, gm1 = np.asarray(theta[0]), np.asarray(gamma[0])
        step1 = jax.jit(make_rollout_fn(arrays, cfg, 1))
        chainT = jax.jit(make_rollout_fn(arrays, cfg, T))
        # (a) dispatch-inclusive per-step wall clock: one host->device
        # call per control tick
        lats = measure_step_latencies(arrays, cfg, refs1, w1, th1, gm1,
                                      step_fn=step1)
        # (b) device-only per-step time (batch-1 chained rollout,
        # back-to-back steps on a warm device)
        dev_step_s, dispatch_s = device_step_time(
            arrays, cfg, refs1, w1, th1, gm1, chain_fn=chainT,
            step_fn=step1)
        lat = {"p99_step_ms": float(np.quantile(lats, 0.99) * 1e3),
               "p50_step_ms": float(np.median(lats) * 1e3),
               "step_device_ms": dev_step_s * 1e3,
               "dispatch_overhead_ms": dispatch_s * 1e3}

    result = {
        "metric": f"closed-loop lossy-network tube-MPC rollouts/s (N=10, T={T})",
        "value": rollouts_per_s,
        "unit": "rollouts/s",
        "qp_solves_per_s": qp_solves_per_s,
        **(lat or {"p99_step_ms": "not measured"}),
        # amortized throughput figure (NOT a latency): one batched step
        "batched_step_amortized_ms": dt_total * 1e3 / T,
        "realtime_budget_ms": 20.0,
        "compile_and_first_run_s": compile_s,
        "batch": BATCH,
        "T": T,
        "solver": SOLVER,
        "admm_iters": ITERS,
        "admm_iters2": ITERS2,
        "alpha": ALPHA,
        "rho2_scale": RHO2_SCALE,
        "early_tol": EARLY_TOL,
        "polish": POLISH,
        "dtype": str(dtype),
        "matmul_precision": get_matmul_precision(),
        "feasible_frac": feasible_frac,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "n_devices": n_dev,
        "card": card_info(),
        **roof,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
