"""Multi-process launch path (single-process coverage).

These tests pin the launcher's single-process semantics and the
global-mesh + sharded-array assembly on the virtual 8-device CPU mesh —
the parts of ``parallel/distributed.py`` that run identically across
hosts.  ``test_distributed_two_process.py`` runs two real processes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rtmpc_tpu.parallel.distributed import (
    distributed_mc_arrays, global_dp_mesh, initialize_from_env,
    is_distributed)


def test_initialize_single_process_is_noop(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    assert initialize_from_env() is False
    assert not is_distributed()
    # explicit single process: also a no-op
    assert initialize_from_env(num_processes=1) is False


def test_initialize_multi_process_without_coordinator_raises(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_from_env()


def test_global_dp_mesh_spans_all_devices():
    mesh = global_dp_mesh()
    assert mesh.axis_names == ("dp",)
    assert mesh.devices.size == len(jax.devices()) == 8  # conftest mesh


def test_distributed_mc_arrays_single_process_roundtrip():
    mesh = global_dp_mesh()
    a = np.arange(16 * 3, dtype=np.float64).reshape(16, 3)
    b = np.arange(16, dtype=np.int64)
    ga, gb = distributed_mc_arrays(mesh, a, b)
    assert ga.shape == a.shape and gb.shape == b.shape
    np.testing.assert_array_equal(np.asarray(ga), a)
    np.testing.assert_array_equal(np.asarray(gb), b)
    # actually sharded over the dp axis
    assert len(ga.sharding.device_set) == 8
    # and consumable by a jitted reduction without resharding
    s = jax.jit(lambda x: jnp.sum(x))(ga)
    assert float(s) == a.sum()


def test_mc_sweep_accepts_global_mesh():
    """run_mc_sweep(mesh=...) consumes the launcher's mesh end-to-end."""
    from rtmpc_tpu.utils import box
    from rtmpc_tpu.models import setup_tube_tracking
    from rtmpc_tpu.parallel.mc import run_mc_sweep

    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0], [1.0]])
    setup = setup_tube_tracking(A, B, np.eye(2), np.eye(1), 5,
                                box(np.array([8.0, 8.0])),
                                box(np.array([1.0])),
                                box(np.array([0.1, 0.1])),
                                fixed_initial_state=True)
    arrays, cfg = setup.to_device(dtype=jnp.float64, iters=40, iters2=40,
                                  alpha=1.8, rho2_scale=0.2)
    T = 12
    refs = np.zeros((T, 2))
    refs[:, 0] = 1.0
    res = run_mc_sweep(
        arrays, cfg, T=T, n_mc=4, loss_probs=[0.0, 0.5], refs=refs,
        x0=np.zeros(2), w_lo=-0.1 * np.ones(2), w_hi=0.1 * np.ones(2),
        key=jax.random.PRNGKey(0), mesh=global_dp_mesh())
    assert res.feasible.all()
    assert np.isfinite(res.tracking_error).all()
