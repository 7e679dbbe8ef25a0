"""Fused Pallas ADMM kernel parity vs the vmapped XLA path.

Runs the kernel in interpreter mode (tests force the CPU backend, see
``conftest.py``).  The kernel compiled for the card is checked by the
``gpu``-marked test below and by ``chip_smoke.py`` (through
``tools/parity_checks.py``) — the same functions, no ``interpret=True``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rtmpc_tpu.utils import box
from rtmpc_tpu.models import setup_tube_tracking
from rtmpc_tpu.ops.qp import admm_solve, init_admm_state, ADMMState
from rtmpc_tpu.ops.qp_pallas import admm_solve_pallas, pow2_width


def _flagship():
    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0], [1.0]])
    return setup_tube_tracking(
        A, B, np.eye(2), np.eye(1), 10,
        box(np.array([8.0, 8.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])), fixed_initial_state=True)


def _flagship_spec(dtype=jnp.float32):
    arrays, cfg = _flagship().to_device(dtype=dtype, iters=60)
    return arrays.admm


def test_pallas_matches_vmapped_admm_cold_start():
    spec = _flagship_spec()
    rng = np.random.default_rng(0)
    B = 12                                   # exercises batch padding too
    theta = jnp.asarray(rng.uniform(-2, 2, (B, 4)), jnp.float32)

    ref = jax.vmap(lambda t: admm_solve(spec, t, init_admm_state(spec),
                                        iters=40))(theta)
    pal = admm_solve_pallas(spec, theta, iters=40, block_b=8,
                            interpret=True)

    np.testing.assert_allclose(np.asarray(pal.z_primal),
                               np.asarray(ref.z_primal), atol=1e-5)
    # residuals are diagnostics; f32 accumulation order differs between
    # the interpreter's dot and XLA's, so compare loosely
    np.testing.assert_allclose(np.asarray(pal.r_prim),
                               np.asarray(ref.r_prim), rtol=5e-2, atol=1e-4)
    np.testing.assert_allclose(np.asarray(pal.r_dual),
                               np.asarray(ref.r_dual), rtol=5e-2, atol=1e-4)


def test_pallas_warm_start_state_round_trip():
    """The returned state warm-starts the next solve identically to the
    per-element path (the rollout carries it across scan steps)."""
    spec = _flagship_spec()
    rng = np.random.default_rng(1)
    B = 8
    th1 = jnp.asarray(rng.uniform(-1, 1, (B, 4)), jnp.float32)
    th2 = jnp.asarray(rng.uniform(-1, 1, (B, 4)), jnp.float32)

    ref1 = jax.vmap(lambda t: admm_solve(spec, t, init_admm_state(spec),
                                         iters=25))(th1)
    ref2 = jax.vmap(lambda t, s: admm_solve(spec, t, s, iters=25))(
        th2, ref1.state)

    pal1 = admm_solve_pallas(spec, th1, iters=25, block_b=8, interpret=True)
    pal2 = admm_solve_pallas(spec, th2, pal1.state, iters=25, block_b=8,
                             interpret=True)

    np.testing.assert_allclose(np.asarray(pal2.z_primal),
                               np.asarray(ref2.z_primal), atol=1e-5)
    np.testing.assert_allclose(np.asarray(pal2.state.y),
                               np.asarray(ref2.state.y), atol=2e-3)


def test_pallas_batched_rollout_parity():
    """solver="pallas" is a production path: the batch-level rollout built
    by ``make_batched_rollout`` must reproduce the vmapped-XLA engine's
    closed-loop trajectories on the flagship lossy-network scenario."""
    from rtmpc_tpu.protocol import draw_loss_masks, draw_disturbances
    from rtmpc_tpu.parallel import make_batched_rollout

    setup = _flagship()
    arrays, cfg_admm = setup.to_device(dtype=jnp.float32, iters=40)
    _, cfg_pal = setup.to_device(dtype=jnp.float32, iters=40,
                                 solver="pallas", pallas_interpret=True,
                                 pallas_block=8)
    B, T, nx = 6, 12, 2
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    theta, gamma = draw_loss_masks(k1, T, 0.5, 0.5, batch_shape=(B,))
    w = draw_disturbances(k2, T, -0.1 * np.ones(nx), 0.1 * np.ones(nx),
                          batch_shape=(B,)).astype(jnp.float32)
    refs = jnp.zeros((B, T, nx), jnp.float32).at[:, :, 0].set(4.0)
    x0 = jnp.zeros((B, nx), jnp.float32)

    c1, o1 = jax.jit(make_batched_rollout(arrays, cfg_admm, T))(
        x0, refs, w, theta, gamma)
    c2, o2 = jax.jit(make_batched_rollout(arrays, cfg_pal, T))(
        x0, refs, w, theta, gamma)
    np.testing.assert_allclose(np.asarray(o2.x), np.asarray(o1.x),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(o2.u), np.asarray(o1.u),
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(c2.feasible),
                                  np.asarray(c1.feasible))
    # warm-start carries line up too (scaled iterates)
    np.testing.assert_allclose(np.asarray(c2.admm.x),
                               np.asarray(c1.admm.x), atol=1e-4)


def test_pallas_batched_rollout_polish_parity():
    """polish=True in pallas mode routes through the shared
    ``polish_solution`` per element; trajectories must match the vmapped
    polished engine."""
    from rtmpc_tpu.protocol import draw_loss_masks, draw_disturbances
    from rtmpc_tpu.parallel import make_batched_rollout

    setup = _flagship()
    arrays, cfg_admm = setup.to_device(dtype=jnp.float32, iters=30,
                                       polish=True)
    _, cfg_pal = setup.to_device(dtype=jnp.float32, iters=30, polish=True,
                                 solver="pallas", pallas_interpret=True,
                                 pallas_block=8)
    B, T, nx = 4, 8, 2
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    theta, gamma = draw_loss_masks(k1, T, 0.6, 0.6, batch_shape=(B,))
    w = draw_disturbances(k2, T, -0.1 * np.ones(nx), 0.1 * np.ones(nx),
                          batch_shape=(B,)).astype(jnp.float32)
    refs = jnp.zeros((B, T, nx), jnp.float32).at[:, :, 0].set(3.0)
    x0 = jnp.zeros((B, nx), jnp.float32)

    c1, o1 = jax.jit(make_batched_rollout(arrays, cfg_admm, T))(
        x0, refs, w, theta, gamma)
    c2, o2 = jax.jit(make_batched_rollout(arrays, cfg_pal, T))(
        x0, refs, w, theta, gamma)
    np.testing.assert_allclose(np.asarray(o2.x), np.asarray(o1.x),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(o2.r_dual),
                               np.asarray(o1.r_dual), rtol=0.2, atol=1e-5)


@pytest.mark.parametrize("v,want", [(1, 16), (16, 16), (17, 32), (40, 64),
                                    (112, 128), (128, 128)])
def test_pow2_width(v, want):
    """Kernel widths and batch tiles: powers of two, at least the Triton
    dot's minimum of 16."""
    assert pow2_width(v) == want


def test_pallas_high_precision_split_matches():
    """The 3-pass bf16 path ("high") stays within its arithmetic envelope
    of the IEEE path on the flagship spec."""
    from rtmpc_tpu.ops.precision import matmul_precision
    spec = _flagship_spec()
    rng = np.random.default_rng(2)
    theta = jnp.asarray(rng.uniform(-2, 2, (16, 4)), jnp.float32)
    exact = admm_solve_pallas(spec, theta, iters=30, interpret=True)
    with matmul_precision("high"):
        split = admm_solve_pallas(spec, theta, iters=30, interpret=True)
    np.testing.assert_allclose(np.asarray(split.z_primal),
                               np.asarray(exact.z_primal), atol=5e-3)
    assert not np.array_equal(np.asarray(split.z_primal),
                              np.asarray(exact.z_primal))


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_on_gpu(gpu_device):
    """The kernel compiled for the card vs the vmapped XLA solve."""
    import sys
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import parity_checks
    spec = _flagship_spec()
    gate = parity_checks.Gate()
    with jax.default_device(gpu_device):
        for prec in ("highest", "high"):
            parity_checks.check_kernel(gate, spec, 60, 1024, prec)
    assert gate.ok, gate.result
