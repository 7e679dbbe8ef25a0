"""ADMM solver parity vs the float64 interior-point oracle.

Covers all QP template shapes used by the five controller variants on the
reference's own configurations (double integrator from the Examples, the
linearized cartpole geometry in miniature).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rtmpc_tpu.ops.assembly import build_mpc_qp
from rtmpc_tpu.ops.qp import prepare_admm, admm_solve, init_admm_state
from rtmpc_tpu.utils.synthesis import dlqr, dlyap


A = np.array([[1.0, 1.0], [0.0, 1.0]])
B = np.array([[0.0], [1.0]])
Q = np.eye(2)
R = np.eye(1)
NX, NU = 2, 1


def _gains():
    K, _, _ = dlqr(A, B, Q, R)
    Qlyap = Q + K.T @ R @ K
    P = dlyap(A - B @ K, (Qlyap + Qlyap.T) / 2)
    return K, P


def _check_parity(tmpl, thetas, iters=400, tol=2e-5):
    spec = prepare_admm(tmpl, dtype=jnp.float64)
    solve = jax.jit(lambda th: admm_solve(spec, th, iters=iters))
    for th in thetas:
        sol_ip, _ = tmpl.solve_dense(th[:NX], th[NX:])
        assert sol_ip.status == "optimal"
        sol_admm = solve(jnp.asarray(th))
        z = np.asarray(sol_admm.z_primal)[:tmpl.n]
        err = np.max(np.abs(z - sol_ip.z))
        scale = 1.0 + np.max(np.abs(sol_ip.z))
        assert err / scale < tol, (
            f"ADMM vs IP mismatch {err:.2e} (rel {err/scale:.2e}), "
            f"residuals p={float(sol_admm.r_prim):.2e} "
            f"d={float(sol_admm.r_dual):.2e}")


def test_regulator_template():
    # RegulatorMPC config (Example_of_Regulator_MPC.py): N=10, |u|<=1
    tmpl = build_mpc_qp(A, B, Q, R, 10,
                        Hu=np.array([[1.0], [-1.0]]), hu=np.ones(2))
    thetas = [np.array([1.0, 2.0, 0, 0]), np.array([-3.0, 0.5, 0, 0])]
    _check_parity(tmpl, thetas)


def test_tracking_template_no_terminal():
    K, P = _gains()
    tmpl = build_mpc_qp(
        A, B, Q, R, 10, tracking=True, P_term=P, Tout=10 * P,
        Hx=np.vstack([np.eye(2), -np.eye(2)]), hx=8 * np.ones(4),
        Hu=np.array([[1.0], [-1.0]]), hu=np.ones(2))
    thetas = [np.array([1.0, 2.0, 5.0, 0.0]),
              np.array([0.0, 0.0, -9.0, 0.0])]
    _check_parity(tmpl, thetas, iters=800)


def test_tube_regulator_template():
    K, P = _gains()
    # initial-state tube = small box
    Hz = np.vstack([np.eye(2), -np.eye(2)])
    hz = 0.3 * np.ones(4)
    tmpl = build_mpc_qp(
        A, B, Q, R, 9, P_term=P,
        Hx=np.vstack([np.eye(2), -np.eye(2)]), hx=np.array([10, 2, 10, 10.0]),
        Hu=np.array([[1.0], [-1.0]]), hu=np.ones(2),
        HxN=np.vstack([np.eye(2), -np.eye(2)]), hxN=np.ones(4),
        init_mode="tube", Hz=Hz, hz=hz)
    thetas = [np.array([-5.0, -2.0, 0, 0]), np.array([3.0, 1.0, 0, 0])]
    _check_parity(tmpl, thetas)


def test_tube_tracking_template_augmented_terminal():
    K, P = _gains()
    # toy augmented terminal set: box over (x_N, xbar, ubar)
    HxN = np.vstack([np.eye(5), -np.eye(5)])
    hxN = np.concatenate([8 * np.ones(2), 8 * np.ones(2), [1.0]] * 2)
    tmpl = build_mpc_qp(
        A, B, Q, R, 10, tracking=True, P_term=P, Tout=10 * P,
        Hx=np.vstack([np.eye(2), -np.eye(2)]), hx=7 * np.ones(4),
        Hu=np.array([[1.0], [-1.0]]), hu=0.8 * np.ones(2),
        HxN=HxN, hxN=hxN, terminal_augmented=True,
        init_mode="fixed")
    thetas = [np.array([1.0, 2.0, 5.0, 0.0]),
              np.array([1.0, 2.0, -9.0, 0.0]),
              np.array([0.0, 0.0, 4.0, 0.0])]
    _check_parity(tmpl, thetas)


def test_warm_start_reduces_iters():
    """Warm-started re-solve of a perturbed problem reaches the same
    solution with far fewer iterations."""
    K, P = _gains()
    tmpl = build_mpc_qp(
        A, B, Q, R, 10, tracking=True, P_term=P, Tout=10 * P,
        Hx=np.vstack([np.eye(2), -np.eye(2)]), hx=8 * np.ones(4),
        Hu=np.array([[1.0], [-1.0]]), hu=np.ones(2))
    spec = prepare_admm(tmpl, dtype=jnp.float64)
    th0 = jnp.array([1.0, 2.0, 5.0, 0.0])
    th1 = jnp.array([1.1, 1.9, 5.0, 0.0])
    sol0 = admm_solve(spec, th0, iters=400)
    cold = admm_solve(spec, th1, iters=30)
    warm = admm_solve(spec, th1, state=sol0.state, iters=30)
    assert float(warm.r_dual) < float(cold.r_dual)
    ip, _ = tmpl.solve_dense(np.array(th1[:2]), np.array(th1[2:]))
    err_warm = np.max(np.abs(np.asarray(warm.z_primal)[:tmpl.n] - ip.z))
    err_cold = np.max(np.abs(np.asarray(cold.z_primal)[:tmpl.n] - ip.z))
    assert err_warm < err_cold


def test_batched_vmap_solve():
    tmpl = build_mpc_qp(A, B, Q, R, 10,
                        Hu=np.array([[1.0], [-1.0]]), hu=np.ones(2))
    spec = prepare_admm(tmpl, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    thetas = np.zeros((16, 4))
    thetas[:, :2] = rng.uniform(-2, 2, size=(16, 2))
    batched = jax.jit(jax.vmap(lambda th: admm_solve(spec, th, iters=300)))
    sols = batched(jnp.asarray(thetas))
    for i in range(16):
        ip, _ = tmpl.solve_dense(thetas[i, :2])
        z = np.asarray(sols.z_primal[i])[:tmpl.n]
        np.testing.assert_allclose(z, ip.z, atol=5e-5)
