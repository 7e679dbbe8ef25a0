"""Paper Figs. 3b/3c reproduction: nonlinear cartpole Monte-Carlo sweep.

Equivalent of ``Results/results_nonlinear_system.py``: the controllers are
designed on the *linearized* model but the plant is the nonlinear cartpole
stepped at 500 Hz with zero-order-hold of the 50 Hz control
(``physics_timestep=1/500``, ``lim_zoh=10`` — ref :31-37, :255-329).
PyBullet is replaced by the analytic rigid-body ODE (vmappable), so the
whole sweep is one batched scan; the "disturbance" is the linearization
error, implicitly bounded by the estimated W.
"""

import time

import numpy as np

from .common import (check, init_jax, make_parser, savefig,
                     save_summary_json, solver_kwargs)
from .scenarios import cartpole_scenario


def build_nonlinear_plant_step(jnp, sc, method="semi_implicit_euler"):
    from ..models.plants import cartpole_zoh_step

    def plant_step(x, u, w):
        # w unused: the model/physics mismatch IS the disturbance
        return cartpole_zoh_step(sc.params, x, u[0], sc.Th,
                                 sc.physics_substeps, method=method)

    return plant_step


def main(argv=None):
    parser = make_parser(__doc__)
    parser.add_argument("--n-mc", type=int, default=20)
    parser.add_argument("--no-cache", action="store_true")
    parser.add_argument("--extended", action="store_true",
                        help="add the ExtendedTubeTrackingMPC arm "
                             "(results_nonlinear_system_with_extendedMPC)")
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
    track = cached_setup(setup_tracking, sc.A, sc.B, sc.Q, sc.R, sc.N,
                         sc.X, sc.U, cache=not args.no_cache)
    setups = {"RT-MPC": (tube, "consistent", None),
              "R-MPC": (track, "smart", "certificate")}
    if args.extended:
        ext = cached_setup(setup_extended_tube_tracking, sc.A, sc.B, sc.Q,
                           sc.R, sc.N, sc.X, sc.U, sc.W,
                           fixed_initial_state=False, rpi_method=1,
                           cache=not args.no_cache)
        # the reference's NONLINEAR extended benchmark stops this arm on QP
        # infeasibility too (``ext_tube_feasible``,
        # ``results_nonlinear_system_with_extendedMPC.py:324,374``)
        setups["Ext-RT-MPC"] = (ext, "consistent", "certificate")
    print(f"setups done in {time.time() - t0:.1f}s")

    dtype = jnp.dtype(args.dtype)
    plant_step = build_nonlinear_plant_step(jnp, sc)
    refs = np.zeros((T, 4))
    refs[:, 0] = sc.ref_value
    key = jax.random.PRNGKey(args.seed)

    results = {}
    # Noise model: the reference's nonlinear benchmark draws NO process
    # noise — the 500 Hz physics/linearization mismatch IS the disturbance
    # (``results_nonlinear_system.py:255-329``); only the loss masks and
    # (in the full reference) initial conditions randomize across MC runs.
    # A zero-width disturbance box makes that explicit (the drawn w tensor
    # is all zeros and the plant step takes only (x, u)).
    for name, (setup, mode, im) in setups.items():
        arrays, cfg = setup.to_device(dtype=dtype,
                                      **solver_kwargs(args, admm_iters=400))
        results[name] = run_mc_sweep(
            arrays, cfg, T=T, n_mc=n_mc, loss_probs=probs, refs=refs,
            x0=sc.x0, w_lo=np.zeros(4), w_hi=np.zeros(4), key=key,
            actuator_mode=mode, infeas_mode=im, plant_step=plant_step,
            n_chunks=args.n_chunks)
        print(f"{name}: wall {results[name].wall_time_s:.2f}s "
              f"infeasible {results[name].infeasible_counts.tolist()}")

    print("\nMean RMS tracking error (nonlinear plant) per loss prob:")
    print("  p   " + "".join(f"{n:>14s}" for n in results))
    rows = []
    for i, p in enumerate(probs):
        row = {"p": float(p)}
        for name in results:
            row[f"rms_{name}"] = float(
                np.nanmean(results[name].tracking_error[i]))
            row[f"infeasible_{name}"] = int(
                results[name].infeasible_counts[i])
        rows.append(row)
        print(f"  {p:.1f} " + "".join(
            f"{np.nanmean(results[name].tracking_error[i]):14.5f}"
            for name in results))
    save_summary_json(args.save_json, {
        "app": "results_nonlinear", "extended": bool(args.extended),
        "solver": args.solver, "dtype": args.dtype,
        "backend": jax.default_backend(), "n_mc": n_mc, "T": T,
        "seed": args.seed, "rows": rows})

    tube_res = results["RT-MPC"]
    ok = check("tube arm feasible on the nonlinear plant",
               bool(tube_res.feasible.all()))
    # angle constraint |phi| <= 0.3 on the sampled trajectories
    max_ang = max(float(np.abs(tube_res.sample_traj[i][:, 2]).max())
                  for i in range(len(probs)))
    ok &= check("angle constraint held by the tube arm",
                max_ang <= 0.3 + 1e-3, f"max |phi| = {max_ang:.4f}")

    if not args.no_figures:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        # Fig. 3b/3c: tracking-error BOXPLOTS per loss probability
        # (``results_nonlinear_system.py:428-433``) — NaN (infeasible)
        # runs filtered like the reference
        figb, axb = plt.subplots(figsize=(9, 5))
        n_arms = len(results)
        pos = np.arange(len(probs)) * (n_arms + 0.5)
        colors = {"RT-MPC": "C0", "R-MPC": "C1", "Ext-RT-MPC": "C2"}
        handles = []
        for ai, (name, res) in enumerate(results.items()):
            data = [res.tracking_error[i][~np.isnan(res.tracking_error[i])]
                    for i in range(len(probs))]
            data = [d if d.size else np.array([np.nan]) for d in data]
            bp = axb.boxplot(
                data, positions=pos + (ai - (n_arms - 1) / 2) * 0.8,
                widths=0.6, patch_artist=True, sym="x",
                boxprops=dict(facecolor=colors.get(name, f"C{ai}")))
            handles.append(bp["boxes"][0])
        axb.set_xticks(pos)
        axb.set_xticklabels([f"{p:.1f}" for p in probs])
        axb.set_xlabel("Packet Loss Probability")
        axb.set_ylabel("Average Tracking Error (nonlinear plant)")
        axb.legend(handles, list(results))
        suffix = "_extended" if args.extended else ""
        savefig(figb, f"results_nonlinear{suffix}_boxplot.png")

        fig, (ax1, ax2) = plt.subplots(nrows=2, figsize=(8, 5))
        pi = min(range(len(probs)), key=lambda i: abs(probs[i] - 0.4))
        tg = sc.Th * np.arange(T)
        for name, res in results.items():
            ax1.plot(tg, res.sample_traj[pi, :, 0], label=name)
            ax2.plot(tg, res.sample_traj[pi, :, 2], label=name)
        ax1.axhline(sc.ref_value, color="k", lw=1)
        ax1.set_ylabel("Position p [m]"); ax1.legend(); ax1.grid()
        ax2.axhline(0.3, color="r"); ax2.axhline(-0.3, color="r")
        ax2.set_ylabel("Angle phi [rad]"); ax2.set_xlabel("Time [s]")
        ax2.grid()
        suffix = "_extended" if args.extended else ""
        savefig(fig, f"results_nonlinear{suffix}_trajectories.png")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
