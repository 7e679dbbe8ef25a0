"""Closed-loop parity: JAX scanned/branchless engine vs sequential oracle.

Configs mirror the reference examples (double integrator, N=10, X=+-8,
U=+-1, W=+-0.1, loss prob 0.7 both directions — the flagship
``Example_of_Tube_Tracking_MPC_Over_Lossy_Network.py``), with shared
pre-drawn disturbance/loss realizations so both implementations see
identical data.  Also promotes the reference's printed runtime checks to
assertions:

* Proposition 1 (Umsonst-Barbosa): estimation error is zero whenever
  Theta_t == 1  (ref :165-179).
* Tube membership: x_t - x_nom_t in Z at every step (ref :181-184).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rtmpc_tpu.utils.polytope import box, contains
from rtmpc_tpu.models.specs import (setup_extended_tube_tracking,
                                    setup_tracking, setup_tube_tracking)
from rtmpc_tpu.parallel.rollout import make_rollout_fn, tracking_error_rms

from oracle_protocol import run_oracle_rollout

T = 40
NX, NU = 2, 1
A = np.array([[1.0, 1.0], [0.0, 1.0]])
B = np.array([[0.0], [1.0]])
Q = np.eye(2)
R = np.eye(1)
X = box(np.array([8.0, 8.0]))
U = box(np.array([1.0]))
W = box(np.array([0.1, 0.1]))
X0 = np.array([1.0, 2.0])


def _draw_inputs(seed, p=0.7):
    rng = np.random.default_rng(seed)
    theta = (rng.uniform(size=T) >= p).astype(np.int64)
    gamma = (rng.uniform(size=T) >= p).astype(np.int64)
    theta[0] = gamma[0] = 1
    w = rng.uniform(-0.1, 0.1, size=(T, NX))
    refs = np.zeros((T, NX))
    refs[:10, 0] = 5.0
    refs[10:20, 0] = -9.0   # deliberately outside X: steady state saturates
    refs[20:, 0] = 4.0
    return refs, w, theta, gamma


def _run_engine(setup, refs, w, theta, gamma, mode, iters=400,
                polish=False, solver="admm"):
    arrays, cfg = setup.to_device(dtype=jnp.float64, iters=iters,
                                  polish=polish, solver=solver,
                                  probe_thetas=np.array(
                                      [[1.0, 2.0, 5.0, 0.0],
                                       [0.0, 0.0, -9.0, 0.0]]))
    fn = make_rollout_fn(arrays, cfg, T, actuator_mode=mode)
    carry, outs = jax.jit(fn)(
        jnp.asarray(X0), jnp.asarray(refs), jnp.asarray(w),
        jnp.asarray(theta, jnp.int32), jnp.asarray(gamma, jnp.int32))
    return carry, jax.tree_util.tree_map(np.asarray, outs)


@pytest.fixture(scope="module")
def tube_setup():
    return setup_tube_tracking(A, B, Q, R, 10, X, U, W,
                               fixed_initial_state=True)


def test_flagship_tube_tracking_parity(tube_setup):
    refs, w, theta, gamma = _draw_inputs(11)
    oracle = run_oracle_rollout(tube_setup, X0, refs, w, theta, gamma)
    assert oracle["feasible"] and oracle["steps"] == T
    carry, outs = _run_engine(tube_setup, refs, w, theta, gamma,
                              "consistent")
    assert bool(carry.feasible)
    np.testing.assert_allclose(outs.x, oracle["x"], atol=2e-4,
                               err_msg="plant trajectories diverge")
    np.testing.assert_allclose(outs.x_nom, oracle["x_nom"], atol=2e-4)
    np.testing.assert_allclose(outs.u, oracle["u"], atol=2e-4)
    np.testing.assert_array_equal(outs.Theta, oracle["Theta"])


def test_flagship_invariants(tube_setup):
    """Proposition 1 + tube membership, asserted on the engine outputs."""
    refs, w, theta, gamma = _draw_inputs(12)
    carry, outs = _run_engine(tube_setup, refs, w, theta, gamma,
                              "consistent")
    Z = tube_setup.Z
    xs = np.vstack([X0[None], outs.x[:-1]])       # x_t for t = 0..T-1
    # tube membership every step (reference check :181-184)
    for t in range(T):
        assert contains(Z, xs[t] - outs.x_nom[t], tol=1e-6), \
            f"tube violated at t={t}"
    # Proposition 1 (tube form, reference check :165-179): the estimation
    # error e_t = x_t - x_hat_t lies in Z whenever Theta_t == 1
    hits = 0
    for t in range(T):
        if outs.Theta[t] == 1:
            e = xs[t] - outs.x_hat[t]
            assert contains(Z, e, tol=1e-6), \
                f"Prop 1 violated at t={t}: e={e}"
            hits += 1
    assert hits > 3  # the scenario must actually exercise the property


def test_tracking_smart_actuator_parity():
    """Non-tube remote tracking MPC (Pezzutto protocol, SmartActuator)."""
    setup = setup_tracking(A, B, Q, R, 10, X, U)
    refs, w, theta, gamma = _draw_inputs(13)
    w = np.zeros_like(w)  # reference example has no disturbance here
    oracle = run_oracle_rollout(setup, X0, refs, w, theta, gamma,
                                actuator_mode="smart")
    assert oracle["feasible"]
    carry, outs = _run_engine(setup, refs, w, theta, gamma, "smart")
    n = oracle["steps"]
    np.testing.assert_allclose(outs.x[:n], oracle["x"], atol=2e-4)
    np.testing.assert_array_equal(outs.Theta[:n], oracle["Theta"])


def test_extended_tube_tracking_parity():
    setup = setup_extended_tube_tracking(A, B, Q, R, 10, X, U,
                                         box(np.array([0.05, 0.05])),
                                         fixed_initial_state=False)
    refs, w, theta, gamma = _draw_inputs(14)
    w = np.clip(w, -0.05, 0.05)
    oracle = run_oracle_rollout(setup, X0, refs, w, theta, gamma)
    assert oracle["feasible"]
    # engine in interior-point mode: both sides now solve each QP to
    # Clarabel-class accuracy, so this asserts pure PROTOCOL parity of the
    # extended (two-QP, robust-estimator) machinery
    carry, outs = _run_engine(setup, refs, w, theta, gamma, "consistent",
                              solver="ip")
    dx = np.abs(outs.x - oracle["x"]).max(axis=1)
    assert dx.max() < 1e-4, f"worst-step divergence {dx.max():.3e}"
    np.testing.assert_array_equal(outs.Theta, oracle["Theta"])


def test_tracking_error_metric():
    xs = np.ones((5, 2))
    refs = np.zeros((5, 2))
    x0 = np.zeros(2)
    err = float(tracking_error_rms(x0, jnp.asarray(xs), jnp.asarray(refs)))
    # traj = [x0, 1,1,1,1]; sum err^2 = 4*(1+1) = 8
    np.testing.assert_allclose(err, np.sqrt(8.0) / 5, rtol=1e-12)


def test_draws_are_x64_invariant():
    """The f32 pin in protocol/network.py: the same key must yield
    bit-identical masks and (up to cast) disturbances whether or not x64
    is enabled — otherwise f64-CPU truth runs and f32 accelerator runs are
    unpaired experiments (round-4 fix)."""
    import jax
    from rtmpc_tpu.protocol.network import (draw_disturbances,
                                            draw_loss_masks)

    key = jax.random.PRNGKey(42)
    th64, gm64 = draw_loss_masks(key, 50, 0.4, 0.7, batch_shape=(3,))
    w64 = draw_disturbances(key, 50, -0.1 * np.ones(2), 0.1 * np.ones(2),
                            batch_shape=(3,))
    try:
        jax.config.update("jax_enable_x64", False)
        th32, gm32 = draw_loss_masks(key, 50, 0.4, 0.7, batch_shape=(3,))
        w32 = draw_disturbances(key, 50, -0.1 * np.ones(2),
                                0.1 * np.ones(2), batch_shape=(3,))
    finally:
        jax.config.update("jax_enable_x64", True)
    np.testing.assert_array_equal(np.asarray(th64), np.asarray(th32))
    np.testing.assert_array_equal(np.asarray(gm64), np.asarray(gm32))
    np.testing.assert_allclose(np.asarray(w64), np.asarray(w32, np.float64),
                               atol=1e-7)
