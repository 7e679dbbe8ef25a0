"""Device-resident 50 Hz controller session — the deployment story, executable.

Runs one continuous closed-loop control session (default 15,000 ticks = 5
minutes of 50 Hz control) with the controller state resident on the
device, the host streaming measurements/masks in windows, and reports the
sustained per-tick latency distribution (p50/p99 across windows) against
the 20 ms real-time budget
(``/root/reference/Results/results_linear_system.py:304-320``).

Two measured granularities:

* device-resident (the deployment mode): the rollout carry (estimator,
  actuator, warm starts) never leaves the device; each dispatch advances
  a WINDOW of ticks in one scan.  Within a window the per-tick cost is
  deterministic by construction — fixed-iteration ADMM, static shapes, no
  data-dependent control flow — so worst-case == average on-device; the
  p50/p99 across windows measures the real jitter of a sustained session
  (including the window-boundary dispatches, which an infeed-fed
  deployment would also hide).
* per-dispatch (the reference's methodology): one host->device call per
  control tick, printed with the no-op dispatch floor beside it.

The protocol step equals the Results apps' engine (same
``make_rollout_fn``), so this is the flagship controller actually served,
not a stripped kernel.
"""

import time

import numpy as np

from .common import check, init_jax, make_parser


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--ticks", type=int, default=15000,
                        help="total control ticks (default 5 min @ 50 Hz)")
    parser.add_argument("--window", type=int, default=150,
                        help="ticks per device dispatch (3 s @ 50 Hz)")
    parser.add_argument("--loss-prob", type=float, default=0.4)
    parser.add_argument("--per-dispatch-ticks", type=int, default=120,
                        help="ticks for the per-dispatch (reference "
                             "methodology) measurement")
    args = parser.parse_args(argv)
    jax = init_jax(args)
    import jax.numpy as jnp
    from ..models import setup_tube_tracking
    from ..parallel.latency import latency_report, measure_step_latencies
    from ..parallel.rollout import init_carry, make_rollout_fn
    from ..utils import box

    # flagship controller (Example_of_Tube_Tracking_MPC_Over_Lossy_Network)
    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0], [1.0]])
    setup = setup_tube_tracking(
        A, B, np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)
    dtype = jnp.dtype(args.dtype)
    arrays, cfg = setup.to_device(dtype=dtype, iters=60, iters2=60,
                                  alpha=1.8, rho2_scale=0.2)

    T, K = args.ticks, args.window
    n_win = T // K
    T = n_win * K
    budget_ms = 20.0
    rng = np.random.default_rng(args.seed)
    p = args.loss_prob

    # the served reference: piecewise-constant setpoint changing every 10 s
    refs = np.zeros((T, 2))
    levels = rng.uniform(-6, 6, size=(T // 500 + 1,))
    for i in range(len(levels)):
        refs[i * 500:(i + 1) * 500, 0] = levels[i]
    theta = (rng.uniform(size=T) >= p).astype(np.int64)
    gamma = (rng.uniform(size=T) >= p).astype(np.int64)
    theta[0] = gamma[0] = 1
    w = rng.uniform(-0.1, 0.1, size=(T, 2))

    x0 = np.zeros(2)
    step_win = jax.jit(make_rollout_fn(arrays, cfg, K))

    print(f"device: {jax.devices()[0]}  solver: {args.solver}  "
          f"dtype: {args.dtype}")
    print(f"session: {T} ticks = {T / 50.0:.0f} s of 50 Hz control, "
          f"{n_win} windows x {K} ticks, loss p={p}")

    # warm-up / compile (one window shape only)
    c0 = init_carry(arrays, cfg, x0, K)
    out = step_win(jnp.asarray(x0, dtype), jnp.asarray(refs[:K], dtype),
                   jnp.asarray(w[:K], dtype),
                   jnp.asarray(theta[:K], jnp.int32),
                   jnp.asarray(gamma[:K], jnp.int32), c0)
    out[1].x.block_until_ready()

    # ---- the sustained device-resident session -------------------------
    carry = init_carry(arrays, cfg, x0, K)
    win_wall = np.empty(n_win)
    xs_last = None
    feasible = True
    t_session0 = time.perf_counter()
    for iw in range(n_win):
        sl = slice(iw * K, (iw + 1) * K)
        t0 = time.perf_counter()
        carry, outs = step_win(
            jnp.asarray(x0, dtype),         # ignored: carry holds state
            jnp.asarray(refs[sl], dtype), jnp.asarray(w[sl], dtype),
            jnp.asarray(theta[sl], jnp.int32),
            jnp.asarray(gamma[sl], jnp.int32), carry)
        outs.x.block_until_ready()
        win_wall[iw] = time.perf_counter() - t0
        xs_last = outs
    session_s = time.perf_counter() - t_session0
    feasible = bool(np.asarray(carry.feasible))

    per_tick_ms = win_wall / K * 1e3
    p50 = float(np.median(per_tick_ms))
    p99 = float(np.quantile(per_tick_ms, 0.99))
    mx = float(np.max(per_tick_ms))
    misses = int(np.sum(win_wall > K * budget_ms / 1e3))
    rate = T / session_s
    print(f"\ndevice-resident session: {session_s:.2f} s wall for "
          f"{T} ticks -> {rate:,.0f} ticks/s "
          f"({rate / 50.0:,.0f}x the 50 Hz real-time rate)")
    print(f"per-tick latency across {n_win} windows [ms]: "
          f"p50={p50:.4f} p99={p99:.4f} max={mx:.4f} "
          f"(window-boundary dispatch amortized over {K} ticks)")
    print(f"window deadline misses (window wall > {K} x 20 ms): "
          f"{misses}/{n_win}")

    ok = check("sustained per-tick p99 within the 20 ms budget",
               p99 < budget_ms, f"p99 {p99:.4f} ms")
    ok &= check("zero window deadline misses", misses == 0)
    ok &= check("session stayed feasible", feasible)
    # the session really controlled something: the last window tracks the
    # final setpoint despite 40% loss both ways
    final_err = float(np.mean(np.abs(
        np.asarray(xs_last.x)[-50:, 0] - refs[-1, 0])))
    ok &= check("closed loop tracks the served setpoint",
                final_err < 0.5,
                f"mean |x1 - ref| over last second = {final_err:.3f} "
                f"(ref {refs[-1, 0]:+.2f})")

    # ---- per-dispatch granularity (reference methodology) --------------
    Tpd = args.per_dispatch_ticks
    lats = measure_step_latencies(arrays, cfg, refs[:Tpd], w[:Tpd],
                                  theta[:Tpd], gamma[:Tpd], x0=x0)
    latency_report(lats, "one dispatch per tick")
    import jax.numpy as _j
    nop = jax.jit(lambda v: v + 1.0)
    v0 = _j.zeros(())
    nop(v0).block_until_ready()
    fl = []
    for _ in range(20):
        t0 = time.perf_counter()
        nop(v0).block_until_ready()
        fl.append(time.perf_counter() - t0)
    print(f"  (no-op dispatch floor: "
          f"{np.median(fl) * 1e3:.3f} ms)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
