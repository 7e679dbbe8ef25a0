"""Per-step solver shootout on the GPU: vmapped-XLA ADMM vs the fused
Pallas (Triton) kernel, both compiled for the card, plus a parity check
between the two.

Each measurement chains STEPS warm-started solves inside one ``lax.scan``,
exactly how the rollout engine invokes the solver, and sweeps the kernel's
batch tile and warp count.

Usage: python tools/bench_pallas_kernel.py [B] [ITERS] [STEPS]
"""

import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import jax
import jax.numpy as jnp

from rtmpc_tpu.utils import box
from rtmpc_tpu.utils.compile_cache import enable_compile_cache
from rtmpc_tpu.models import setup_tube_tracking
from rtmpc_tpu.ops.qp import admm_solve, init_admm_state, ADMMState
from rtmpc_tpu.ops.qp_pallas import admm_solve_pallas
from rtmpc_tpu.ops import precision

TILES = (16, 32, 64)
WARPS = (4, 8)


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    ITERS = int(sys.argv[2]) if len(sys.argv) > 2 else 60
    STEPS = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    REPS = 5
    enable_compile_cache()

    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    Bm = np.array([[0.0], [1.0]])
    setup = setup_tube_tracking(
        A, Bm, np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)
    arrays, _ = setup.to_device(iters=ITERS)
    spec = arrays.admm
    n_p, m_p = spec.Kinv.shape[0], spec.As.shape[0]
    dev = jax.devices()[0]
    print(f"device: {dev.device_kind}  n_p: {n_p}  m_p: {m_p}  "
          f"B: {B}  iters: {ITERS}  chained steps: {STEPS}")

    rng = np.random.default_rng(0)
    thetas = jnp.asarray(rng.uniform(-2, 2, (STEPS, B, 4)), jnp.float32)

    def scan_xla(thetas):
        def step(st, th):
            sol = jax.vmap(lambda t, s: admm_solve(spec, t, s, iters=ITERS)
                           )(th, st)
            return sol.state, sol.z_primal
        st0 = jax.vmap(lambda _: init_admm_state(spec))(jnp.arange(B))
        return jax.lax.scan(step, st0, thetas)

    def make_scan_pallas(bb, warps):
        def scan_pallas(thetas):
            def step(st, th):
                sol = admm_solve_pallas(spec, th, st, iters=ITERS,
                                        block_b=bb, num_warps=warps)
                return sol.state, sol.z_primal
            st0 = ADMMState(x=jnp.zeros((B, n_p), jnp.float32),
                            y=jnp.zeros((B, m_p), jnp.float32),
                            z=jnp.zeros((B, m_p), jnp.float32))
            return jax.lax.scan(step, st0, thetas)
        return scan_pallas

    def timeit(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)            # compile
        jax.block_until_ready(out)
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / REPS / STEPS
        print(f"{name:34s} {dt*1e3:9.4f} ms/step  "
              f"{B/dt/1e6:8.3f} Msolves/s  (compile+first {t_c:.1f} s)",
              flush=True)
        return out, dt

    for prec in ("highest", "high"):
        precision.set_matmul_precision(prec)
        jax.clear_caches()
        (_, z_ref), dt_x = timeit(f"xla vmap admm  [{prec}]",
                                  jax.jit(scan_xla), thetas)
        for bb in TILES:
            for warps in WARPS:
                name = f"kernel tile={bb:<3d} warps={warps} [{prec}]"
                try:
                    (_, z_p), dt_p = timeit(
                        name, jax.jit(make_scan_pallas(bb, warps)), thetas)
                except Exception as e:      # report, keep sweeping
                    print(f"{name} FAILED: {type(e).__name__}: "
                          f"{str(e)[:300]}", flush=True)
                    continue
                err = float(jnp.max(jnp.abs(z_p - z_ref)))
                print(f"   max |z_kernel - z_xla| (all steps) = {err:.3e}   "
                      f"speedup vs xla: {dt_x/dt_p:.2f}x", flush=True)


if __name__ == "__main__":
    main()
