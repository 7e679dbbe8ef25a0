"""Two-phase rho-schedule sweep on device: f32 parity vs oracle + throughput.

    python tools/sweep_schedule.py
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

    import json
    cases_env = os.environ.get("SCHED_CASES")
    if cases_env:
        cases = [(dict(c), json.dumps(c)) for c in json.loads(cases_env)]
    else:
        cases = [
            (dict(iters=300), "fixed300"),
            (dict(iters=100, iters2=100, alpha=1.8), "100+100 a1.8"),
            (dict(iters=80, iters2=80, alpha=1.8), "80+80 a1.8"),
            (dict(iters=120, iters2=60, alpha=1.8), "120+60 a1.8"),
            (dict(iters=80, iters2=80), "80+80 a1.6"),
        ]
    for kw, label in cases:
        arrays, cfg = setup.to_device(dtype=jnp.float32, **kw)
        fn1 = jax.jit(make_rollout_fn(arrays, cfg, T))
        c1, o1 = fn1(jnp.asarray(x01, jnp.float32),
                     jnp.asarray(refs1, jnp.float32),
                     jnp.asarray(w1, jnp.float32),
                     jnp.asarray(theta1, jnp.int32),
                     jnp.asarray(gamma1, jnp.int32))
        terr = float(np.max(np.abs(np.asarray(o1.x) - oracle["x"])))

        roll = jax.jit(make_batched_rollout(arrays, cfg, T))
        # batched parity (the binding gate constraint: a batched matmul
        # lowers differently from the per-element mat-vec — the batched
        # section of tools/parity_checks.py)
        Bb = 64
        rep = lambda a, dt2: jnp.broadcast_to(
            jnp.asarray(a, dt2), (Bb,) + np.asarray(a).shape)
        rollb = jax.jit(make_batched_rollout(arrays, cfg, T))
        cb, ob = rollb(rep(x01, jnp.float32), rep(refs1, jnp.float32),
                       rep(w1, jnp.float32), rep(theta1, jnp.int32),
                       rep(gamma1, jnp.int32))
        berr = float(np.max(np.abs(np.asarray(ob.x) - oracle["x"][None])))

        c, o = roll(x0B, refsB, wB, thetaB, gammaB)
        o.x.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(3):
            c, o = roll(x0B, refsB, wB, thetaB, gammaB)
        o.x.block_until_ready()
        dt = (time.perf_counter() - t0) / 3
        tot = kw["iters"] + kw.get("iters2", 0)
        print(f"{label:14s} tot={tot:3d} traj_err={terr:.2e} "
              f"batched_err={berr:.2e} rollouts/s={BATCH/dt:,.0f}")


if __name__ == "__main__":
    main()
