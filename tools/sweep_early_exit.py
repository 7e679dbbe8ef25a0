"""Sweep early-exit settings: trajectory parity vs f64 oracle + throughput.

For each (early_tol, dual_factor) setting, runs the flagship T=120 f32
rollout against the float64 protocol oracle (the parity_checks
methodology) and times the batched B=4096 rollout — the data for choosing
the shipped early-exit default.

    python tools/sweep_early_exit.py
"""

import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))


def main():
    import jax
    import jax.numpy as jnp
    from rtmpc_tpu.ops.precision import set_matmul_precision
    set_matmul_precision("high")
    from rtmpc_tpu.utils import box
    from rtmpc_tpu.models import setup_tube_tracking
    from rtmpc_tpu.protocol import draw_loss_masks, draw_disturbances
    from rtmpc_tpu.parallel import make_batched_rollout
    from rtmpc_tpu.parallel.rollout import make_rollout_fn
    from oracle_protocol import run_oracle_rollout

    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    Bm = np.array([[0.0], [1.0]])
    setup = setup_tube_tracking(
        A, Bm, np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)

    T, BATCH = 120, 4096
    rng = np.random.default_rng(7)
    theta1 = (rng.uniform(size=T) >= 0.7).astype(np.int64)
    gamma1 = (rng.uniform(size=T) >= 0.7).astype(np.int64)
    theta1[0] = gamma1[0] = 1
    w1 = rng.uniform(-0.1, 0.1, size=(T, 2))
    refs1 = np.zeros((T, 2))
    refs1[:T // 4, 0] = 5.0
    refs1[T // 4:T // 2, 0] = -9.0
    refs1[T // 2:, 0] = 4.0
    x01 = np.zeros(2)
    oracle = run_oracle_rollout(setup, x01, refs1, w1, theta1, gamma1)
    assert oracle["feasible"]

    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    thetaB, gammaB = draw_loss_masks(k1, T, 0.7, 0.7, batch_shape=(BATCH,))
    wB = draw_disturbances(k2, T, -0.1 * np.ones(2), 0.1 * np.ones(2),
                           batch_shape=(BATCH,)).astype(jnp.float32)
    refsB = jnp.broadcast_to(jnp.asarray(refs1, jnp.float32),
                             (BATCH, T, 2))
    x0B = jnp.zeros((BATCH, 2), jnp.float32)

    settings = [
        dict(iters=300, early_tol=None),
        dict(iters=300, early_tol=1e-4, dual_factor=25.0),
        dict(iters=300, early_tol=1e-4, dual_factor=100.0),
        dict(iters=300, early_tol=3e-4, dual_factor=100.0),
        dict(iters=400, early_tol=1e-4, dual_factor=50.0),
    ]
    for st in settings:
        kw = dict(iters=st["iters"])
        if st["early_tol"] is not None:
            kw.update(early_tol=st["early_tol"],
                      early_dual_factor=st["dual_factor"])
            label = f"b{st['iters']} {st['early_tol']:g}/df{st['dual_factor']:g}"
        else:
            label = f"b{st['iters']} fixed"
        arrays, cfg = setup.to_device(dtype=jnp.float32, **kw)
        fn1 = jax.jit(make_rollout_fn(arrays, cfg, T))
        c1, o1 = fn1(jnp.asarray(x01, jnp.float32),
                     jnp.asarray(refs1, jnp.float32),
                     jnp.asarray(w1, jnp.float32),
                     jnp.asarray(theta1, jnp.int32),
                     jnp.asarray(gamma1, jnp.int32))
        terr = float(np.max(np.abs(np.asarray(o1.x) - oracle["x"])))

        roll = jax.jit(make_batched_rollout(arrays, cfg, T))
        c, o = roll(x0B, refsB, wB, thetaB, gammaB)
        o.x.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(3):
            c, o = roll(x0B, refsB, wB, thetaB, gammaB)
        o.x.block_until_ready()
        dt = (time.perf_counter() - t0) / 3
        print(f"{label:18s} iters={st['iters']:4d} "
              f"traj_err={terr:.2e} rollouts/s={BATCH/dt:,.0f}")


if __name__ == "__main__":
    main()
