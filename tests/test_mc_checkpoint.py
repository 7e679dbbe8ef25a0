"""MC-sweep chunking + checkpoint/resume matches the single-shot sweep.

The reference keeps Monte-Carlo results only in in-memory dicts
(``results_linear_system.py:151-157``) — a crash loses the sweep.  Here the
accumulator flushes to an ``.npz`` per chunk and resumes; randomness is
drawn up front from the key, so chunked, resumed, and single-shot runs must
agree to reduction-order noise (~1e-15 in f64; XLA schedules reductions
differently for different batch shapes).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rtmpc_tpu.utils import box
from rtmpc_tpu.models import setup_tube_tracking
from rtmpc_tpu.parallel.mc import run_mc_sweep


@pytest.fixture(scope="module")
def flagship():
    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0], [1.0]])
    setup = setup_tube_tracking(
        A, B, np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)
    return setup.to_device(dtype=jnp.float64, iters=80)


def _sweep(flagship, **kw):
    arrays, cfg = flagship
    T = 15
    refs = np.zeros((T, 2))
    refs[:, 0] = 4.0
    return run_mc_sweep(
        arrays, cfg, T=T, n_mc=3, loss_probs=[0.0, 0.3, 0.6, 0.8],
        refs=refs, x0=np.zeros(2), w_lo=-0.1 * np.ones(2),
        w_hi=0.1 * np.ones(2), key=jax.random.PRNGKey(7),
        sample_mc_index=1, **kw)


def test_chunked_matches_single_shot(flagship, tmp_path):
    ref = _sweep(flagship)
    ck = str(tmp_path / "sweep.ckpt")
    chunked = _sweep(flagship, checkpoint_path=ck, n_chunks=3)
    np.testing.assert_allclose(chunked.tracking_error, ref.tracking_error,
                               rtol=1e-12)
    np.testing.assert_array_equal(chunked.feasible, ref.feasible)
    np.testing.assert_allclose(chunked.sample_traj, ref.sample_traj,
                               atol=1e-12)


def test_resume_after_partial_run(flagship, tmp_path):
    """Emulate a crash after chunk 2 of 4 by rewinding the checkpoint's
    ``next_chunk`` and poisoning the not-yet-done rows; the resumed run must
    recompute exactly those rows and reproduce the single-shot result."""
    import os

    ck = str(tmp_path / "sweep.ckpt")
    ref = _sweep(flagship)

    _sweep(flagship, checkpoint_path=ck, n_chunks=4)
    ckd = dict(np.load(ck))
    ckd["next_chunk"] = np.int64(2)
    ckd["err"][2:] = 123.0
    np.savez(ck + ".tmp.npz", **ckd)
    os.replace(ck + ".tmp.npz", ck)

    resumed = _sweep(flagship, checkpoint_path=ck, n_chunks=4)
    np.testing.assert_allclose(resumed.tracking_error, ref.tracking_error,
                               rtol=1e-12)
    np.testing.assert_array_equal(resumed.feasible, ref.feasible)
    # poisoned rows were recomputed, untouched rows came from the checkpoint
    assert not np.any(resumed.tracking_error == 123.0)


def test_time_chunked_sweep_matches_single_shot():
    """t_chunk splits the scan into carry-threaded dispatches; must be
    bit-identical to the single-shot run."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from rtmpc_tpu.utils import box
    from rtmpc_tpu.models import setup_tube_tracking
    from rtmpc_tpu.parallel.mc import run_mc_sweep

    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0], [1.0]])
    setup = setup_tube_tracking(
        A, B, np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)
    arrays, cfg = setup.to_device(dtype=jnp.float64, solver="ip_riccati",
                                  ip_iters=25)
    T = 40
    refs = np.zeros((T, 2))
    refs[:, 0] = 4.0
    kw = dict(T=T, n_mc=3, loss_probs=[0.0, 0.6], refs=refs,
              x0=np.zeros(2), w_lo=-0.1 * np.ones(2),
              w_hi=0.1 * np.ones(2), key=jax.random.PRNGKey(5))
    r1 = run_mc_sweep(arrays, cfg, **kw)
    r2 = run_mc_sweep(arrays, cfg, t_chunk=16, **kw)
    np.testing.assert_allclose(r2.tracking_error, r1.tracking_error,
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(r2.sample_traj, r1.sample_traj)
