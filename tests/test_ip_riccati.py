"""Structured (Riccati/arrowhead) interior point vs the f64 dense oracle.

The solver (``ops/ip_riccati.py``) replaces the flat-KKT LU of
``ops/ip.py`` with a stagewise Riccati sweep + w-Schur border; these
tests pin (a) the hand-rolled pivoted-LU building block, (b) primal
parity with ``QPTemplate.solve_dense`` across controller variants and
init modes, and (c) the mixed-precision hybrid driver (f32 path
following + f64 polish) that the accelerator accuracy mode runs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rtmpc_tpu.utils.polytope import box
from rtmpc_tpu.models.specs import (setup_regulator, setup_tracking,
                                    setup_tube_regulator)
from rtmpc_tpu.ops.ip_riccati import (_plu_factor, _plu_solve,
                                      prepare_ip_riccati, ip_riccati_solve,
                                      ip_riccati_solve_hybrid)


def test_small_pivoted_lu():
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 9):
        A = jnp.asarray(rng.standard_normal((4, n, n)))
        b = jnp.asarray(rng.standard_normal((4, n)))
        Bm = jnp.asarray(rng.standard_normal((4, n, 3)))
        fac = _plu_factor(A)
        x = np.asarray(_plu_solve(fac, b))
        X = np.asarray(_plu_solve(fac, Bm))
        ref = np.linalg.solve(np.asarray(A), np.asarray(b)[..., None])
        assert np.abs(x - ref[..., 0]).max() < 1e-10
        assert np.abs(X - np.linalg.solve(np.asarray(A),
                                          np.asarray(Bm))).max() < 1e-10


DI_A = np.array([[1.0, 1.0], [0.0, 1.0]])
DI_B = np.array([[0.0], [1.0]])


@pytest.fixture(scope="module")
def tracking_setup():
    return setup_tracking(DI_A, DI_B, np.eye(2), np.array([[0.1]]), 10,
                          box(np.array([8.0, 8.0])), box(np.array([1.0])))


def _check_parity(tmpl, cases, tol, solve):
    for x0, ref in cases:
        sol_ref, theta = tmpl.solve_dense(np.array(x0), np.array(ref))
        assert sol_ref.status == "optimal"
        z = np.asarray(solve(jnp.asarray(theta)))
        assert np.abs(z - sol_ref.z).max() < tol, (x0, ref)


def test_riccati_tracking_parity_f64(tracking_setup):
    tmpl = tracking_setup.template
    spec = prepare_ip_riccati(tmpl, dtype=jnp.float64)
    _check_parity(
        tmpl,
        [([1.0, 0.0], [5.0, 0.0]), ([-3.0, 2.0], [-9.0, 0.0]),
         ([0.0, 0.0], [9.0, 0.0])],
        1e-6,
        lambda th: ip_riccati_solve(spec, th, tmpl.N, iters=30).z_primal)


def test_riccati_regulator_parity_f64():
    st = setup_regulator(DI_A, DI_B, np.eye(2), np.array([[0.1]]), 10,
                         U=box(np.array([1.0])))
    spec = prepare_ip_riccati(st.template, dtype=jnp.float64)
    _check_parity(
        st.template,
        [([-4.0, 1.5], [0.0, 0.0]), ([2.0, -1.0], [0.0, 0.0])],
        1e-6,
        lambda th: ip_riccati_solve(spec, th, st.template.N,
                                    iters=30).z_primal)


def test_riccati_tube_regulator_parity_f64():
    """Tube-init (free x_0) mode, Mayne geometry
    (``Example_of_Tube_Regulator_MPC.py:19-56``)."""
    st = setup_tube_regulator(
        DI_A, np.array([[0.5], [1.0]]), np.eye(2), np.array([[0.01]]), 9,
        box(np.array([100.0, 2.0])), box(np.array([1.0])),
        box(np.array([0.1, 0.1])))
    spec = prepare_ip_riccati(st.template, dtype=jnp.float64)
    _check_parity(
        st.template,
        [([-6.0, 0.0], [0.0, 0.0]), ([-4.0, 1.0], [0.0, 0.0])],
        1e-6,
        lambda th: ip_riccati_solve(spec, th, st.template.N,
                                    iters=30).z_primal)


def test_riccati_hybrid_matches_f64(tracking_setup):
    """The f32+f64 hybrid lands on the f64 answer (the accelerator accuracy
    mode's precision contract)."""
    tmpl = tracking_setup.template
    spec = prepare_ip_riccati(tmpl, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    solve64 = jax.jit(lambda th: ip_riccati_solve(
        spec, th, tmpl.N, iters=30).z_primal)
    solveh = jax.jit(lambda th: ip_riccati_solve_hybrid(
        spec, th, tmpl.N, iters32=25, iters64=15).z_primal)
    for _ in range(6):
        x0 = rng.uniform(-4, 4, size=2)
        ref = np.array([rng.uniform(-8, 8), 0.0])
        theta = jnp.asarray(np.concatenate([x0, ref]))
        z64 = np.asarray(solve64(theta))
        zh = np.asarray(solveh(theta))
        assert np.abs(zh - z64).max() < 1e-5


def test_riccati_batched_vmap(tracking_setup):
    tmpl = tracking_setup.template
    spec = prepare_ip_riccati(tmpl, dtype=jnp.float64)
    thetas = jnp.asarray(np.array([[1.0, 0.0, 5.0, 0.0],
                                   [-3.0, 2.0, -9.0, 0.0],
                                   [0.5, -0.5, 3.0, 0.0]]))
    zs = jax.jit(jax.vmap(lambda th: ip_riccati_solve(
        spec, th, tmpl.N, iters=30).z_primal))(thetas)
    for i in range(3):
        sol_ref, _ = tmpl.solve_dense(np.asarray(thetas[i, :2]),
                                      np.asarray(thetas[i, 2:]))
        assert np.abs(np.asarray(zs[i]) - sol_ref.z).max() < 1e-6
