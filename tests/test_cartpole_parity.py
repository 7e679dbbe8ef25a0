"""Closed-loop parity at the reference's REAL problem size: the linearized
cartpole (nx=4, N=20, Q=diag(100,10,100,10), R=0.1, angle box +-0.3) of
``/root/reference/Results/results_linear_system.py:26-163`` — not just the
2-D double integrator of the examples.

The cartpole tracking QP is heavily degenerate (504-row irredundant
terminal set in the 9-D augmented space, cond(P_scaled) ~ 1e20), which is
exactly why it must be tested: the f64 interior-point oracle needs its
best-iterate fallback here (utils/qp_ref.py), and the engine's IP mode is
the configuration that reproduces oracle trajectories.  The batched ADMM
mode does NOT reach trajectory parity on this geometry (documented in
ACCURACY.md); its guarantees here are the reference's ROBUSTNESS
invariants (tube membership, constraint satisfaction), asserted
separately.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rtmpc_tpu.apps.scenarios import cartpole_scenario
from rtmpc_tpu.models.specs import setup_tracking, setup_tube_tracking
from rtmpc_tpu.parallel.rollout import make_rollout_fn
from rtmpc_tpu.utils.polytope import contains

from oracle_protocol import run_oracle_rollout

T = 30
P_LOSS = 0.4


@pytest.fixture(scope="module")
def sc():
    return cartpole_scenario()


@pytest.fixture(scope="module")
def tube_setup(sc):
    return setup_tube_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U,
                               sc.W, fixed_initial_state=True, rpi_method=1)


@pytest.fixture(scope="module")
def inputs(sc):
    rng = np.random.default_rng(5)
    theta = (rng.uniform(size=T) >= P_LOSS).astype(np.int64)
    gamma = (rng.uniform(size=T) >= P_LOSS).astype(np.int64)
    theta[0] = gamma[0] = 1
    w = rng.uniform(sc.w_lo, sc.w_hi, size=(T, 4))
    refs = np.zeros((T, 4))
    refs[:, 0] = sc.ref_value
    return refs, w, theta, gamma


@pytest.fixture(scope="module")
def oracle(tube_setup, sc, inputs):
    refs, w, theta, gamma = inputs
    out = run_oracle_rollout(tube_setup, sc.x0, refs, w, theta, gamma)
    assert out["feasible"] and out["steps"] == T
    return out


def _run(setup, sc, inputs, actuator_mode="consistent", **kw):
    refs, w, theta, gamma = inputs
    arrays, cfg = setup.to_device(dtype=jnp.float64, **kw)
    fn = jax.jit(make_rollout_fn(arrays, cfg, T,
                                 actuator_mode=actuator_mode))
    carry, outs = fn(jnp.asarray(sc.x0), jnp.asarray(refs),
                     jnp.asarray(w), jnp.asarray(theta, jnp.int32),
                     jnp.asarray(gamma, jnp.int32))
    return carry, jax.tree_util.tree_map(np.asarray, outs)


def test_cartpole_tube_tracking_parity_ip(tube_setup, sc, inputs, oracle):
    """Engine (IP mode) reproduces the f64 oracle trajectory on the
    reference's benchmark geometry through 30 lossy-network steps."""
    carry, outs = _run(tube_setup, sc, inputs, solver="ip", ip_iters=50)
    assert bool(carry.feasible)
    derr = np.max(np.abs(outs.x - oracle["x"]))
    # the closed loop passes through near-degenerate QPs (non-unique-ish
    # active sets) where 1e-9-converged solvers can pick inputs apart by
    # ~1e-2 — 5e-3 state agreement is the meaningful bar at this scale
    assert derr < 5e-3, f"cartpole trajectory divergence {derr:.2e}"
    np.testing.assert_array_equal(outs.Theta, oracle["Theta"])


def test_cartpole_admm_robustness_invariants(tube_setup, sc, inputs):
    """The default ADMM schedule does not reach trajectory parity on this
    degenerate geometry (ACCURACY.md) — but the reference's runtime
    robustness checks (``results_linear_system.py:257-259``) must still
    hold: tube membership every step and the angle constraint."""
    carry, outs = _run(tube_setup, sc, inputs,
                       iters=80, iters2=80, alpha=1.8, rho2_scale=0.15)
    assert bool(carry.feasible)
    Z = tube_setup.Z
    xs = np.vstack([sc.x0[None], outs.x[:-1]])
    for t in range(T - 1):
        assert contains(Z, outs.x[t] - outs.x_nom[t + 1], tol=5e-2), \
            f"tube violated at t={t}"
    assert np.abs(outs.x[:, 2]).max() <= 0.3 + 1e-2, "angle constraint"


def test_cartpole_tracking_smart_statistics(sc, inputs):
    """Non-robust tracking arm (SmartActuator protocol) at cartpole scale.

    Pathwise parity is NOT well-posed here: under 40% loss the estimate
    drifts toward the constraint boundary and the closed loop passes
    through near-degenerate QPs where two 1e-9-converged interior-point
    solvers legitimately pick inputs ~0.25 apart (measured: the engine's
    own IP at 50 vs 100 iterations diverges pathwise at the same step).
    The reference's figures compare RMS tracking-error STATISTICS
    (``results_linear_system.py:291``) — that is the meaningful bar, and
    it holds to <2% here despite pathwise divergence."""
    setup = setup_tracking(sc.A, sc.B, sc.Q, sc.R, sc.N, sc.X, sc.U)
    refs, w, theta, gamma = inputs
    oracle = run_oracle_rollout(setup, sc.x0, refs, w, theta, gamma,
                                actuator_mode="smart")
    carry, outs = _run(setup, sc, inputs, solver="ip", ip_iters=50,
                       actuator_mode="smart")
    n = oracle["steps"]
    if n < T:
        pytest.skip("oracle infeasible mid-run on this seed")

    def rms(xs):
        traj = np.vstack([sc.x0[None], xs[:-1]])
        return np.sqrt(np.sum((traj[:, 0] - refs[:, 0]) ** 2)
                       + np.sum(traj[:, 1:] ** 2)) / T

    r_o, r_e = rms(oracle["x"]), rms(outs.x)
    assert abs(r_e - r_o) < 0.02 * r_o, f"RMS mismatch {r_o} vs {r_e}"
    np.testing.assert_array_equal(outs.Theta[:n], oracle["Theta"])
    # constraints hold on the engine trajectory (angle box +-0.3)
    assert np.abs(outs.x[:, 2]).max() <= 0.3 + 1e-6
