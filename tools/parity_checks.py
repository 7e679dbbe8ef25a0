"""On-device f32 parity gate (run on the GPU).

Proves the configuration the bench measures — float32, matmul precision
"high" (``ops/precision.py``), the two-phase 60+60 ADMM schedule, no
polish —
against the independent float64 NumPy protocol oracle
(``tests/oracle_protocol.py``), together with the fused ADMM kernel compiled
for the card, the cartpole accuracy modes and the extended arm, with
on-device invariant checks (Proposition 1, tube membership).

    python tools/parity_checks.py                  # all sections
    python tools/parity_checks.py --precision highest --out parity.json

Exits non-zero on any failure.  ``chip_smoke.py`` runs the same sections
by importing this module.

Oracle reference: the reference's own runtime checks at
``Example_of_Tube_Tracking_MPC_Over_Lossy_Network.py:115-184``.
"""

import argparse
import json
import os
import sys
import warnings

import numpy as np

# the f64 IP oracle deliberately drives its barrier stiff near convergence;
# scipy's rcond warnings there are expected (accuracy is residual-checked)
warnings.filterwarnings("ignore", message=".*ill-conditioned matrix.*")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (_ROOT, os.path.join(_ROOT, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

KERNEL_BLOCK = 16       # fused-kernel batch tile used by the gate


class Gate:
    """PASS/FAIL lines plus the numbers behind them."""

    def __init__(self):
        self.ok = True
        self.result = {}

    def check(self, name, ok, detail=""):
        print(f"[{'PASS' if ok else 'FAIL'}] {name}"
              + (f" — {detail}" if detail else ""), flush=True)
        self.ok = self.ok and bool(ok)
        return bool(ok)


def bench_solver_kw():
    """The bench's shipped ADMM configuration (two-phase rho schedule)."""
    import bench
    return dict(iters=bench.DEFAULT_ITERS, iters2=bench.DEFAULT_ITERS2,
                alpha=bench.DEFAULT_ALPHA,
                rho2_scale=bench.DEFAULT_RHO2_SCALE)


def flagship_setup():
    """Double integrator, N=10, X=+-8, U=+-1, W=+-0.1
    (``Example_of_Tube_Tracking_MPC_Over_Lossy_Network``)."""
    from rtmpc_tpu.utils import box
    from rtmpc_tpu.models import setup_tube_tracking
    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0], [1.0]])
    return setup_tube_tracking(
        A, B, np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)


def flagship_refs(T):
    refs = np.zeros((T, 2))
    refs[:T // 4, 0] = 5.0
    refs[T // 4:T // 2, 0] = -9.0
    refs[T // 2:, 0] = 4.0
    return refs


def _flagship_draws(T=120, seed=7):
    rng = np.random.default_rng(seed)
    theta = (rng.uniform(size=T) >= 0.7).astype(np.int64)
    gamma = (rng.uniform(size=T) >= 0.7).astype(np.int64)
    theta[0] = gamma[0] = 1
    w = rng.uniform(-0.1, 0.1, size=(T, 2))
    return theta, gamma, w


def _f32(*arrays):
    import jax.numpy as jnp
    return [jnp.asarray(a, jnp.int32 if np.asarray(a).dtype.kind == "i"
                        else jnp.float32) for a in arrays]


def check_kernel(gate, spec, iters, batch, precision):
    """Compiled fused kernel vs the vmapped XLA solve at ``batch``."""
    import jax
    import jax.numpy as jnp
    from rtmpc_tpu.ops.precision import matmul_precision
    from rtmpc_tpu.ops.qp import admm_solve, init_admm_state
    from rtmpc_tpu.ops.qp_pallas import admm_solve_pallas
    rng = np.random.default_rng(0)
    th = jnp.asarray(rng.uniform(-2, 2, (batch, spec.Mq.shape[1])),
                     jnp.float32)
    with matmul_precision(precision):
        ref = jax.jit(jax.vmap(lambda t: admm_solve(
            spec, t, init_admm_state(spec), iters=iters)))(th)
        pal = jax.jit(lambda t: admm_solve_pallas(
            spec, t, iters=iters, block_b=KERNEL_BLOCK))(th)
    kerr = float(jnp.max(jnp.abs(pal.z_primal - ref.z_primal)))
    gate.result[f"kernel_max_abs_err_{precision}"] = kerr
    # highest: both sides run IEEE f32 products -> tight.  high: the
    # kernel's 3-pass bf16 products against XLA's IEEE f32; after `iters`
    # iterations the envelope is ~1e-3
    ktol = 1e-4 if precision == "highest" else 5e-3
    return gate.check(
        f"compiled fused kernel vs vmapped XLA, batch {batch}, "
        f"{precision} (atol {ktol:g})", kerr < ktol,
        f"max|dz| = {kerr:.3e}")


def check_flagship_element(gate, setup, arrays, cfg):
    """Per-element bench-config rollout vs the f64 oracle + invariants."""
    import jax
    from rtmpc_tpu.utils.polytope import contains
    from rtmpc_tpu.parallel.rollout import make_rollout_fn
    from oracle_protocol import run_oracle_rollout
    T = 120
    theta, gamma, w = _flagship_draws(T)
    refs = flagship_refs(T)
    x0 = np.zeros(2)
    oracle = run_oracle_rollout(setup, x0, refs, w, theta, gamma)
    assert oracle["feasible"] and oracle["steps"] == T

    fn = jax.jit(make_rollout_fn(arrays, cfg, T))
    carry, outs = fn(*_f32(x0, refs, w, theta, gamma))
    outs = jax.tree_util.tree_map(np.asarray, outs)
    terr = float(np.max(np.abs(outs.x - oracle["x"])))
    uerr = float(np.max(np.abs(outs.u - oracle["u"])))
    gate.result["rollout_traj_max_abs_err"] = terr
    gate.result["rollout_u_max_abs_err"] = uerr
    gate.check("f32 bench-config trajectory parity vs f64 oracle (atol 5e-3)",
               terr < 5e-3, f"max|dx| = {terr:.3e}, max|du| = {uerr:.3e}")
    gate.check("consistency indicator Theta exact match",
               bool(np.array_equal(outs.Theta, oracle["Theta"])))
    gate.check("rollout stays feasible on device", bool(carry.feasible))

    # invariant checks ON THE DEVICE OUTPUTS (reference :165-184)
    Z = setup.Z
    e = outs.x_hat - np.vstack([x0, outs.x[:-1]])
    prop1_ok = all(contains(Z, e[t], tol=5e-3)
                   for t in range(T) if outs.Theta[t] == 1)
    gate.check("Proposition 1 on-device: e in Z when Theta=1", prop1_ok,
               f"{int(outs.Theta.sum())} consistent steps")
    # x_nom reported at step t is the PRE-advance nominal state, so the
    # tube invariant pairs the post-step state x_{t+1} (= outs.x[t]) with
    # x_nom_{t+1} (= outs.x_nom[t+1])
    tube_ok = all(contains(Z, outs.x[t] - outs.x_nom[t + 1], tol=5e-3)
                  for t in range(T - 1))
    gate.check("tube membership on-device: x - x_nom in Z", tube_ok)
    return oracle


def check_flagship_batched(gate, setup, arrays, cfg, label, oracle=None):
    """The batched engine (``make_batched_rollout``) vs the oracle.

    Guards the unbatched-vs-batched arithmetic trap: an unbatched matvec
    and the same op under vmap (a matmul) lower differently, so a config
    can look perfect per element and diverge in the production batched
    engine (observed: single-pass-bf16 phase 1 hit 1e28 at step 1 only
    when batched).  Every element of a 64-wide batch must match."""
    import jax
    import jax.numpy as jnp
    from rtmpc_tpu.parallel import make_batched_rollout
    from oracle_protocol import run_oracle_rollout
    T, Bb = 120, 64
    theta, gamma, w = _flagship_draws(T)
    refs = flagship_refs(T)
    x0 = np.zeros(2)
    if oracle is None:
        oracle = run_oracle_rollout(setup, x0, refs, w, theta, gamma)
    roll = jax.jit(make_batched_rollout(arrays, cfg, T))
    rep = [jnp.broadcast_to(a, (Bb,) + a.shape)
           for a in _f32(x0, refs, w, theta, gamma)]
    carry_b, outs_b = roll(*rep)
    xs_b = np.asarray(outs_b.x)
    berr = float(np.max(np.abs(xs_b - oracle["x"][None])))
    gate.result[f"batched_{label}_traj_max_abs_err"] = berr
    gate.check(f"batched {label} rollout parity vs oracle (atol 5e-3)",
               berr < 5e-3, f"max|dx| = {berr:.3e}")
    gate.check(f"batched {label} rollout stays feasible on device",
               bool(np.asarray(carry_b.feasible).all()))
    gate.check(f"batched {label} rollout identical across elements",
               float(np.max(np.abs(xs_b - xs_b[0:1]))) == 0.0)
    return oracle


def check_cartpole(gate):
    """Cartpole geometry (4-D, N=20, the Results-apps benchmark) on device:
    (a) the f32 Ruiz-scaled dense IP and (a2) the hybrid Riccati IP must
    reproduce the f64 oracle trajectory; (b) the ADMM throughput mode must
    hold the robustness invariants (tube membership, Proposition 1) even
    where its QP residuals plateau (~1e-2 on this geometry).
    Reference geometry: ``Results/results_linear_system.py:26-163``."""
    import jax
    import jax.numpy as jnp
    from rtmpc_tpu.apps.scenarios import cartpole_scenario
    from rtmpc_tpu.models.cache import cached_setup
    from rtmpc_tpu.models import setup_tube_tracking
    from rtmpc_tpu.parallel.rollout import make_rollout_fn, tracking_error_rms
    from rtmpc_tpu.utils.polytope import contains
    from oracle_protocol import run_oracle_rollout

    sc = cartpole_scenario()
    cp = cached_setup(setup_tube_tracking, sc.A, sc.B, sc.Q, sc.R, sc.N,
                      sc.X, sc.U, sc.W, fixed_initial_state=True,
                      rpi_method=1)
    Tc = 60
    rng = np.random.default_rng(11)
    th_c = (rng.uniform(size=Tc) >= 0.4).astype(np.int64)
    gm_c = (rng.uniform(size=Tc) >= 0.4).astype(np.int64)
    th_c[0] = gm_c[0] = 1
    w_c = rng.uniform(sc.w_lo, sc.w_hi, size=(Tc, 4))
    refs_c = np.zeros((Tc, 4))
    refs_c[:, 0] = sc.ref_value
    inputs = _f32(sc.x0, refs_c, w_c, th_c, gm_c)

    oracle_c = run_oracle_rollout(cp, sc.x0, refs_c, w_c, th_c, gm_c)
    assert oracle_c["feasible"] and oracle_c["steps"] == Tc

    def rms(xs):
        return float(np.asarray(tracking_error_rms(
            jnp.asarray(sc.x0), jnp.asarray(xs), jnp.asarray(refs_c))))

    rms_orc = rms(oracle_c["x"])

    # (a) f32 dense IP
    arr_ip, cfg_ip = cp.to_device(dtype=jnp.float32, solver="ip",
                                  ip_iters=30)
    _, outs_ip = jax.jit(make_rollout_fn(arr_ip, cfg_ip, Tc))(*inputs)
    outs_ip = jax.tree_util.tree_map(np.asarray, outs_ip)
    dx = np.max(np.abs(outs_ip.x - oracle_c["x"]), axis=1)
    cerr, cmed = float(dx.max()), float(np.median(dx))
    rms_dev = rms(outs_ip.x)
    drel = abs(rms_dev - rms_orc) / rms_orc
    gate.result.update(cartpole_ip_traj_max_abs_err=cerr,
                       cartpole_ip_traj_median_step_err=cmed,
                       cartpole_ip_rms_rel_err=drel)
    # Gate on the benchmark's own statistic (RMS tracking error, the
    # Results apps' reported number) at the 2% criterion, plus a
    # median per-step bound; max|dx| is only sanity-bounded — a single
    # near-threshold f32 event diverges trajectories pointwise.
    gate.check("cartpole 4-D N=20: f32 IP on-device RMS tracking error "
               "within 2% of f64 oracle", drel < 0.02,
               f"rms {rms_dev:.6f} vs {rms_orc:.6f} (drel {drel:.4f})")
    gate.check("cartpole IP: median per-step |dx| < 1e-2", cmed < 1e-2,
               f"median {cmed:.3e}, max {cerr:.3e}")
    gate.check("cartpole IP: max |dx| sanity bound (0.15)", cerr < 0.15)
    gate.check("cartpole IP: Theta exact match",
               bool(np.array_equal(outs_ip.Theta, oracle_c["Theta"])))

    # (a2) hybrid: f32 Riccati path following + f64 polish must land ON
    # the f64 oracle, not merely near it
    jax.config.update("jax_enable_x64", True)
    arr_hy, cfg_hy = cp.to_device(dtype=jnp.float32, solver="ip_hybrid",
                                  ip_iters=25, ip_hybrid_iters=20)
    _, outs_hy = jax.jit(make_rollout_fn(arr_hy, cfg_hy, Tc))(*inputs)
    outs_hy = jax.tree_util.tree_map(np.asarray, outs_hy)
    dx = np.max(np.abs(outs_hy.x - oracle_c["x"]), axis=1)
    herr, hmed = float(dx.max()), float(np.median(dx))
    rms_hy = rms(outs_hy.x)
    hdrel = abs(rms_hy - rms_orc) / rms_orc
    gate.result.update(cartpole_hybrid_traj_max_abs_err=herr,
                       cartpole_hybrid_traj_median_step_err=hmed,
                       cartpole_hybrid_rms_rel_err=hdrel)
    gate.check("cartpole 4-D N=20: hybrid Riccati IP on-device RMS within "
               "0.5% of f64 oracle", hdrel < 0.005,
               f"rms {rms_hy:.6f} vs {rms_orc:.6f} (drel {hdrel:.5f})")
    gate.check("cartpole hybrid: median per-step |dx| < 1e-3", hmed < 1e-3,
               f"median {hmed:.3e}, max {herr:.3e}")
    gate.check("cartpole hybrid: Theta exact match",
               bool(np.array_equal(outs_hy.Theta, oracle_c["Theta"])))

    # (b) ADMM throughput mode: robustness invariants only
    arr_ad, cfg_ad = cp.to_device(dtype=jnp.float32, iters=200, iters2=200,
                                  alpha=1.8, rho2_scale=0.2)
    carry_ad, outs_ad = jax.jit(make_rollout_fn(arr_ad, cfg_ad, Tc))(*inputs)
    outs_ad = jax.tree_util.tree_map(np.asarray, outs_ad)
    Zc, tube_tol = cp.Z, 5e-3
    gate.check("cartpole ADMM: tube membership x - x_nom in Z on device",
               all(contains(Zc, outs_ad.x[t] - outs_ad.x_nom[t + 1],
                            tol=tube_tol) for t in range(Tc - 1)))
    e_c = outs_ad.x_hat - np.vstack([sc.x0, outs_ad.x[:-1]])
    gate.check("cartpole ADMM: Proposition 1 (e in Z when Theta=1) on "
               "device", all(contains(Zc, e_c[t], tol=tube_tol)
                             for t in range(Tc) if outs_ad.Theta[t] == 1))
    gate.check("cartpole ADMM: rollout stays feasible on device",
               bool(np.asarray(carry_ad.feasible)))
    admm_err = float(np.max(np.abs(outs_ad.x - oracle_c["x"])))
    gate.result["cartpole_admm_traj_max_abs_err"] = admm_err  # ungated
    print(f"  cartpole ADMM max|dx| vs oracle (recorded, ungated): "
          f"{admm_err:.3e}")


def check_extended(gate):
    """Extended arm on device vs the f64 oracle: two-QP selection on
    prev_gamma + RobustEstimator + x_nom reset (reference
    ``TubeTrackingMPC.py:307-349``, ``Estimator.py:113-156``), in the
    hybrid accuracy mode and the bench ADMM config."""
    import jax
    import jax.numpy as jnp
    from rtmpc_tpu.utils import box
    from rtmpc_tpu.utils.polytope import contains
    from rtmpc_tpu.models import setup_extended_tube_tracking
    from rtmpc_tpu.parallel.rollout import make_rollout_fn
    from oracle_protocol import run_oracle_rollout
    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0], [1.0]])
    ext = setup_extended_tube_tracking(
        A, B, np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)
    Te = 100
    rng = np.random.default_rng(23)
    th_e = (rng.uniform(size=Te) >= 0.5).astype(np.int64)
    gm_e = (rng.uniform(size=Te) >= 0.5).astype(np.int64)
    th_e[0] = gm_e[0] = 1
    w_e = rng.uniform(-0.1, 0.1, size=(Te, 2))
    refs_e = np.zeros((Te, 2))
    refs_e[:Te // 2, 0] = 5.0
    refs_e[Te // 2:, 0] = -6.0
    x0 = np.zeros(2)
    inputs = _f32(x0, refs_e, w_e, th_e, gm_e)
    oracle_e = run_oracle_rollout(ext, x0, refs_e, w_e, th_e, gm_e)
    assert oracle_e["feasible"] and oracle_e["steps"] == Te

    # accuracy mode (hybrid) — tight parity
    arr_eh, cfg_eh = ext.to_device(dtype=jnp.float32, solver="ip_hybrid",
                                   ip_iters=25, ip_hybrid_iters=20)
    carry_eh, outs_eh = jax.jit(make_rollout_fn(arr_eh, cfg_eh, Te))(*inputs)
    outs_eh = jax.tree_util.tree_map(np.asarray, outs_eh)
    eerr = float(np.max(np.abs(outs_eh.x - oracle_e["x"])))
    euerr = float(np.max(np.abs(outs_eh.u - oracle_e["u"])))
    gate.result.update(extended_hybrid_traj_max_abs_err=eerr,
                       extended_hybrid_u_max_abs_err=euerr)
    gate.check("extended arm (two-QP + RobustEstimator) on-device trajectory "
               "parity vs f64 oracle (atol 5e-3)", eerr < 5e-3,
               f"max|dx| = {eerr:.3e}, max|du| = {euerr:.3e}")
    gate.check("extended: Theta exact match",
               bool(np.array_equal(outs_eh.Theta, oracle_e["Theta"])))
    gate.check("extended: rollout stays feasible on device",
               bool(np.asarray(carry_eh.feasible)))
    gate.check("extended: tube membership x - x_nom in Z on device",
               all(contains(ext.Z, outs_eh.x[t] - outs_eh.x_nom[t + 1],
                            tol=5e-3) for t in range(Te - 1)))

    # throughput mode (bench ADMM config) — same protocol, looser parity
    arr_ea, cfg_ea = ext.to_device(dtype=jnp.float32, **bench_solver_kw())
    _, outs_ea = jax.jit(make_rollout_fn(arr_ea, cfg_ea, Te))(*inputs)
    eaerr = float(np.max(np.abs(np.asarray(outs_ea.x) - oracle_e["x"])))
    gate.result["extended_admm_traj_max_abs_err"] = eaerr
    gate.check("extended ADMM (bench config) trajectory parity vs oracle "
               "(atol 5e-2)", eaerr < 5e-2, f"max|dx| = {eaerr:.3e}")


def run_sections(gate, precision, kernel=True):
    """Sections 2-5: the flagship per-element and batched checks, the
    fused-kernel rollout (``kernel``, at ``precision``), the cartpole and
    extended arms."""
    import jax.numpy as jnp
    from rtmpc_tpu.ops.precision import matmul_precision
    solver_kw = bench_solver_kw()
    setup = flagship_setup()
    arrays, cfg = setup.to_device(dtype=jnp.float32, **solver_kw)
    with matmul_precision(precision):
        oracle = check_flagship_element(gate, setup, arrays, cfg)
        check_flagship_batched(gate, setup, arrays, cfg, "vmapped-XLA",
                               oracle)
        if kernel:
            _, cfg_pal = setup.to_device(dtype=jnp.float32, **solver_kw,
                                         solver="pallas",
                                         pallas_block=KERNEL_BLOCK)
            check_flagship_batched(gate, setup, arrays, cfg_pal,
                                   "fused-kernel", oracle)
    check_cartpole(gate)
    check_extended(gate)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--precision", default="high",
                    choices=["high", "highest"])
    ap.add_argument("--out", default=os.path.join(_ROOT, "results",
                                                  "parity.json"))
    args = ap.parse_args(argv)

    import jax
    from rtmpc_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"parity gate needs a GPU; JAX found {dev.platform!r}")
        return 2
    print(f"device: {dev.device_kind}  precision: {args.precision}")

    gate = Gate()
    gate.result.update(device=dev.device_kind, precision=args.precision,
                       dtype="float32", **bench_solver_kw())
    spec = flagship_setup().to_device(**bench_solver_kw())[0].admm
    check_kernel(gate, spec, bench_solver_kw()["iters"], 16384,
                 args.precision)
    run_sections(gate, args.precision)

    gate.result["pass"] = gate.ok
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(gate.result, f, indent=1)
    print(f"wrote {args.out}")
    return 0 if gate.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
