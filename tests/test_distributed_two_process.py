"""REAL two-process ``jax.distributed`` integration (round-5 ask #6).

Rounds 3-4 shipped the multi-host launch path as code plus a degenerate
single-process test; ``initialize_from_env`` had never executed with
>1 actual process.  This test spawns a localhost coordinator + two CPU
processes (2 virtual devices each -> a 4-device global DP mesh), runs
``run_mc_sweep`` with the batch sharded across both processes, and checks
both processes return the identical result — equal to a single-process
run of the same sweep (the per-element computation is sharding-invariant).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_sweep(tmp_path):
    port = _free_port()
    out_base = str(tmp_path / "dist_res")
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("PYTEST_CURRENT_TEST", None)
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=2",
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
            "RTMPC_DIST_OUT": out_base,
        })
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(_ROOT, "tests",
                                          "distributed_worker.py")],
            env=env, cwd=_ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            f"worker {pid} failed:\n{out[-4000:]}"

    r0 = np.load(out_base + ".p0.npz")
    r1 = np.load(out_base + ".p1.npz")
    # both processes gathered the SAME global result across processes
    np.testing.assert_array_equal(r0["tracking_error"],
                                  r1["tracking_error"])
    np.testing.assert_array_equal(r0["sample_traj"], r1["sample_traj"])
    assert r0["feasible"].all()

    # equals the single-process reference (same seeds; the per-element
    # engine is sharding-invariant)
    import jax
    import jax.numpy as jnp
    from rtmpc_tpu.utils import box
    from rtmpc_tpu.models import setup_tube_tracking
    from rtmpc_tpu.parallel.mc import run_mc_sweep
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
    ref_res = run_mc_sweep(
        arrays, cfg, T=T, n_mc=4, loss_probs=[0.0, 0.5], refs=refs,
        x0=np.zeros(2), w_lo=-0.1 * np.ones(2), w_hi=0.1 * np.ones(2),
        key=jax.random.PRNGKey(3))
    np.testing.assert_allclose(r0["tracking_error"],
                               ref_res.tracking_error, rtol=0, atol=1e-12)
