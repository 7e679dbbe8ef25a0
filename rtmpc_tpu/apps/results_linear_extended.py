"""Extended-MPC 3-arm comparison on the linearized cartpole.

Equivalent of ``Results/results_linear_system_with_extendedMPC.py``:
adds the ExtendedTubeTrackingMPC arm (two QPs selected by the previous
step's gamma, RobustEstimator, ConsistentActuator in extended mode) to the
RT-MPC / R-MPC sweep of ``results_linear``.
"""

import time

import numpy as np

from .common import (check, init_jax, make_parser, savefig,
                     save_summary_json, solver_kwargs,
                     solvetime_hist_figure)
from .scenarios import cartpole_scenario


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--n-mc", type=int, default=20)
    parser.add_argument("--no-cache", action="store_true")
    parser.add_argument("--save-json", default=None,
                        help="write the per-p mean-RMS rows + solver "
                             "config to this path")
    parser.add_argument("--n-chunks", type=int, default=1,
                        help="sweep chunks along the probability axis "
                             "(default 1)")
    args = parser.parse_args(argv)
    jax = init_jax(args, accel_default_solver="ip_hybrid")
    import jax.numpy as jnp
    from ..models import (setup_extended_tube_tracking, setup_tracking,
                          setup_tube_tracking)
    from ..models.cache import cached_setup
    from ..parallel.mc import run_mc_sweep

    sc = cartpole_scenario()
    if args.quick:
        T, n_mc = 60, 3
        probs = [0.0, 0.4, 0.8]
    else:
        T, n_mc = sc.T, args.n_mc
        probs = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]

    t0 = time.time()
    tube = cached_setup(setup_tube_tracking, sc.A, sc.B, sc.Q, sc.R, sc.N,
                        sc.X, sc.U, sc.W, fixed_initial_state=True,
                        rpi_method=1, cache=not args.no_cache)
    ext = cached_setup(setup_extended_tube_tracking, sc.A, sc.B, sc.Q,
                       sc.R, sc.N, sc.X, sc.U, sc.W,
                       fixed_initial_state=False, rpi_method=1,
                       cache=not args.no_cache)
    track = cached_setup(setup_tracking, sc.A, sc.B, sc.Q, sc.R, sc.N,
                         sc.X, sc.U, cache=not args.no_cache)
    print(f"setups done in {time.time() - t0:.1f}s")

    dtype = jnp.dtype(args.dtype)
    arms = {
        "RT-MPC": (tube.to_device(dtype=dtype, **solver_kwargs(args, admm_iters=400)),
                   "consistent", None),
        "Ext-RT-MPC": (ext.to_device(dtype=dtype,
                                     **solver_kwargs(args, admm_iters=400)), "consistent", None),
        "R-MPC": (track.to_device(dtype=dtype, **solver_kwargs(args, admm_iters=400)),
                  "smart", "certificate"),
    }

    refs = np.zeros((T, 4))
    refs[:, 0] = sc.ref_value
    key = jax.random.PRNGKey(args.seed)

    results = {}
    for name, ((arrays, cfg), mode, im) in arms.items():
        results[name] = run_mc_sweep(
            arrays, cfg, T=T, n_mc=n_mc, loss_probs=probs, refs=refs,
            x0=sc.x0, w_lo=sc.w_lo, w_hi=sc.w_hi, key=key,
            actuator_mode=mode, infeas_mode=im, n_chunks=args.n_chunks)
        print(f"{name}: sweep wall time {results[name].wall_time_s:.2f}s")

    print("\nMean RMS tracking error per loss probability:")
    hdr = "  p   " + "".join(f"{n:>14s}" for n in results)
    print(hdr)
    rows = []
    for i, p in enumerate(probs):
        row = f"  {p:.1f} "
        jrow = {"p": float(p)}
        for name in results:
            jrow[f"rms_{name}"] = float(
                np.nanmean(results[name].tracking_error[i]))
            jrow[f"infeasible_{name}"] = int(
                results[name].infeasible_counts[i])
            row += f"{np.nanmean(results[name].tracking_error[i]):14.5f}"
        rows.append(jrow)
        print(row)

    # Dual solve-time histograms (reference
    # ``results_linear_system_with_extendedMPC.py:409-431``): per-step
    # dispatch-inclusive latencies of the plain-tube and extended arms on
    # one representative p=0.4 rollout each.
    from ..parallel.latency import latency_report, measure_step_latencies
    rng = np.random.default_rng(args.seed + 1)
    T_lat = min(T, 120)
    th_l = (rng.uniform(size=T_lat) >= 0.4).astype(np.int64)
    gm_l = (rng.uniform(size=T_lat) >= 0.4).astype(np.int64)
    th_l[0] = gm_l[0] = 1
    w_l = rng.uniform(sc.w_lo, sc.w_hi, size=(T_lat, 4))
    lat_stats = {}
    for name in ("RT-MPC", "Ext-RT-MPC"):
        (arrays, cfg), mode, _ = arms[name]
        lat = measure_step_latencies(arrays, cfg, refs[:T_lat], w_l,
                                     th_l, gm_l, x0=sc.x0,
                                     actuator_mode=mode)
        lat_stats[name] = latency_report(lat, name)
    solvetime_hist_figure(lat_stats,
                          "results_linear_extended_solvetime_hist.png",
                          enabled=not args.no_figures)

    save_summary_json(args.save_json, {
        "app": "results_linear_extended", "solver": args.solver,
        "dtype": args.dtype, "backend": jax.default_backend(),
        "n_mc": n_mc, "T": T, "seed": args.seed, "rows": rows,
        "solve_time_stats": lat_stats})

    ok = check("both tube arms always feasible",
               bool(results["RT-MPC"].feasible.all()
                    and results["Ext-RT-MPC"].feasible.all()))
    # Section IV.F claim: the extended MPC improves (or at least does not
    # worsen) tracking at high loss vs the basic tube MPC
    e_t = np.nanmean(results["RT-MPC"].tracking_error[-1])
    e_e = np.nanmean(results["Ext-RT-MPC"].tracking_error[-1])
    ok &= check("extended arm comparable-or-better at highest loss",
                e_e < 1.5 * e_t, f"ext {e_e:.5f} vs tube {e_t:.5f}")

    if not args.no_figures:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(9, 5))
        pos = np.arange(len(probs)) * 3.0
        offs = {"RT-MPC": -0.7, "Ext-RT-MPC": 0.0, "R-MPC": 0.7}
        colors = {"RT-MPC": "C0", "Ext-RT-MPC": "C2", "R-MPC": "C1"}
        handles = []
        for name, res in results.items():
            data = [res.tracking_error[i][~np.isnan(res.tracking_error[i])]
                    for i in range(len(probs))]
            data = [d if d.size else np.array([np.nan]) for d in data]
            bp = ax.boxplot(data, positions=pos + offs[name], widths=0.6,
                            patch_artist=True, sym="x",
                            boxprops=dict(facecolor=colors[name]))
            handles.append(bp["boxes"][0])
        ax.set_xticks(pos)
        ax.set_xticklabels([f"{p:.1f}" for p in probs])
        ax.set_xlabel("Packet Loss Probability")
        ax.set_ylabel("Average Tracking Error")
        ax.legend(handles, list(results))
        savefig(fig, "results_linear_extended_boxplot.png")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
