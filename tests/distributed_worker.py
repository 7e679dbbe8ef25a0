"""Worker process for the real 2-process ``jax.distributed`` test.

Launched by ``tests/test_distributed_two_process.py`` with environment:
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``,
``JAX_PLATFORMS=cpu``, ``XLA_FLAGS=--xla_force_host_platform_device_count=2``
and ``RTMPC_DIST_OUT`` (npz output path, written by every process).

Runs the actual multi-host launch path end-to-end: distributed init,
global DP mesh over both processes' devices, ``run_mc_sweep`` with the
batch sharded across the mesh, results gathered across processes.
"""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from rtmpc_tpu.parallel.distributed import (global_dp_mesh,
                                                initialize_from_env,
                                                is_distributed)
    assert initialize_from_env(), "distributed init did not engage"
    assert is_distributed()
    assert jax.process_count() == 2, jax.process_count()
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    assert n_global == 4 and n_local == 2, (n_global, n_local)

    from rtmpc_tpu.utils import box
    from rtmpc_tpu.models import setup_tube_tracking
    from rtmpc_tpu.parallel.mc import run_mc_sweep
    import jax.numpy as jnp

    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0], [1.0]])
    setup = setup_tube_tracking(
        A, B, np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)
    arrays, cfg = setup.to_device(dtype=jnp.float64, iters=60, iters2=60,
                                  alpha=1.8, rho2_scale=0.2)
    T = 30
    refs = np.zeros((T, 2))
    refs[:, 0] = 4.0
    mesh = global_dp_mesh()
    assert mesh.devices.size == 4
    res = run_mc_sweep(
        arrays, cfg, T=T, n_mc=4, loss_probs=[0.0, 0.5], refs=refs,
        x0=np.zeros(2), w_lo=-0.1 * np.ones(2), w_hi=0.1 * np.ones(2),
        key=jax.random.PRNGKey(3), mesh=mesh)
    out = os.environ["RTMPC_DIST_OUT"] + f".p{jax.process_index()}"
    np.savez(out, tracking_error=res.tracking_error,
             sample_traj=res.sample_traj, feasible=res.feasible)
    print(f"worker {jax.process_index()}: wrote {out}")


if __name__ == "__main__":
    main()
