"""Closed-loop lossy-network rollout engine: ``lax.scan`` over time,
``vmap`` over scenarios.

This is the canonical per-step protocol of the reference's drivers
(``Example_of_Tube_Tracking_MPC_Over_Lossy_Network.py:115-163``, SURVEY.md
section 3.2) as ONE pure function:

    per step t:
      1. controller solves the tracking QP from the current estimate
         (batched ADMM, warm-started from the previous step's iterates),
      2. encapsulates U_t = [u_nom(0..N-1), ubar + K xbar] and q_t,
      3. the estimator records the sent sequence,
      4. the (smart|consistent) actuator processes the packet gated by the
         theta mask, produces u_t and the reply packet,
      5. the plant advances (linear + disturbance, or nonlinear cartpole),
      6. the estimator processes the reply gated by the gamma mask.

The lossy network is mask *data* (``protocol/network.py``), so the whole
closed loop is deterministic given (x0, refs, w, theta, gamma) and
compiles to a single scan; ``make_batched_rollout`` vmaps it over
scenario batches (disturbance draws x loss realizations x references x
loss probabilities) — the throughput axis ``bench.py`` measures.

Feasibility semantics under batching (SURVEY.md 7.3 item 3): the reference
*stops* an arm when Clarabel reports the QP infeasible (``track_feasible``,
``results_linear_system.py:262-271``); here each batch element carries a
``feasible`` flag driven by OSQP-style primal/dual infeasibility
CERTIFICATES on the ADMM deltas (``ops/qp.py:infeasibility_certificates``,
``infeas_mode="certificate"``) — once certified, the element's state
freezes and its tracking error reports NaN, without branching.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..models.specs import ControllerArrays, ControllerConfig
from ..ops.qp import (ADMMState, admm_solve, infeasibility_certificates,
                      init_admm_state)
from ..ops.ip import ip_solve
from ..protocol.actuator import ActuatorState, actuator_step, init_actuator
from ..ops.precision import mm
from ..protocol.estimator import (EstimatorState, estimator_update,
                                  init_estimator, store_sequence)

__all__ = ["RolloutCarry", "StepOutputs", "init_carry", "make_rollout_fn",
           "make_batched_rollout", "make_direct_rollout",
           "tracking_error_rms"]


class RolloutCarry(NamedTuple):
    x: jax.Array              # (nx,) plant state
    act: ActuatorState
    est: EstimatorState
    admm: ADMMState           # warm-start iterate, normal problem
    admm_pr: ADMMState        # warm-start iterate, packet-received problem
    prev_gamma: jax.Array     # () int32 — gamma of the previous step
    feasible: jax.Array       # () bool
    infeas_count: jax.Array   # () int32 consecutive high-residual steps


class StepOutputs(NamedTuple):
    x: jax.Array              # (nx,) plant state AFTER the step (x_{t+1})
    u: jax.Array              # (nu,) applied input
    x_nom: jax.Array          # (nx,) actuator nominal state at step t
    x_hat: jax.Array          # (nx,) estimate the controller used at step t
    Theta: jax.Array          # () int32 consistency indicator
    r_prim: jax.Array         # () QP primal residual (scaled)
    r_dual: jax.Array         # () QP dual residual (scaled)
    feasible: jax.Array       # () bool after this step


def init_carry(arrays: ControllerArrays, cfg: ControllerConfig, x0,
               T: int) -> RolloutCarry:
    dtype = arrays.A.dtype
    x0 = jnp.asarray(x0, dtype).reshape(cfg.nx)
    if cfg.solver in ("ip_riccati", "ip_hybrid"):
        from ..ops.ip_riccati import init_ip_state
        sdt = jnp.float32 if cfg.solver == "ip_hybrid" else None
        warm = init_ip_state(arrays.ric, cfg.N, dtype=sdt)
        warm_pr = init_ip_state(arrays.ric_pr, cfg.N, dtype=sdt)
    else:
        warm = init_admm_state(arrays.admm)
        warm_pr = init_admm_state(arrays.admm_pr)
    return RolloutCarry(
        x=x0,
        act=init_actuator(cfg.N, cfg.nx, cfg.nu, x0, dtype),
        est=init_estimator(T, cfg.N, cfg.nx, cfg.nu, x0, dtype),
        admm=warm,
        admm_pr=warm_pr,
        prev_gamma=jnp.ones((), jnp.int32),
        feasible=jnp.ones((), jnp.bool_),
        infeas_count=jnp.zeros((), jnp.int32),
    )


def _extract_packet(arrays: ControllerArrays, cfg: ControllerConfig, z):
    """Encapsulation (``TubeTrackingMPC.encapsulate`` :211-227 /
    ``TrackingMPC.encapsulate`` :143-158): U_t = [u_nom(.), ubar + K xbar].
    Also returns the optimal initial nominal state x_nom(0) and xbar."""
    u_traj = z[cfg.u_off:cfg.u_off + cfg.N * cfg.nu].reshape(cfg.N, cfg.nu)
    if cfg.tracking:
        xbar = z[cfg.xbar_off:cfg.xbar_off + cfg.nx]
        ubar = z[cfg.ubar_off:cfg.ubar_off + cfg.nu]
        u_ss = ubar + mm(arrays.K_ss, xbar)
    else:
        xbar = jnp.zeros(cfg.nx, z.dtype)
        u_ss = jnp.zeros(cfg.nu, z.dtype)
    U_t = jnp.concatenate([u_traj, u_ss[None]], axis=0)
    x_nom0 = z[:cfg.nx]
    return U_t, x_nom0, xbar


def _recover(arrays, cfg, sol, pr=False):
    """Condensed-form recovery: map the reduced-space primal back to the
    full variable layout (z_full = S_rec @ v) so every downstream offset
    (u_off, xbar_off, x_nom0) keeps working."""
    if not cfg.condensed:
        return sol
    S = arrays.S_rec_pr if (pr and cfg.extended) else arrays.S_rec
    n_red = cfg.n_red_pr if (pr and cfg.extended) else cfg.n_red
    z_full = mm(S, sol.z_primal[..., :n_red])
    return sol._replace(z_primal=z_full)


def _solve(arrays, cfg, theta_qp, warm_state, pr=False):
    """Dispatch to the configured QP solver, returning an ADMMSolution-like
    object (z_primal, state, r_prim, r_dual) with z_primal in the FULL
    variable layout.  The IP path ignores (and passes through) the
    warm-start state."""
    if cfg.solver == "ip":
        spec = arrays.ip_pr if pr else arrays.ip
        sol = ip_solve(spec, theta_qp, iters=cfg.ip_iters)
        from ..ops.qp import ADMMSolution
        sol = ADMMSolution(z_primal=sol.z_primal, state=warm_state,
                           r_prim=sol.r_prim, r_dual=sol.r_dual)
        return _recover(arrays, cfg, sol, pr)
    if cfg.solver in ("ip_riccati", "ip_hybrid"):
        # structured accuracy mode: already returns the FULL layout; the
        # interior state warm-starts the NEXT step's solve (in steady
        # tracking consecutive QPs differ by one disturbance draw, so the
        # while-loop converges in a couple of iterations)
        from ..ops.ip_riccati import (ip_riccati_solve,
                                      ip_riccati_solve_hybrid)
        from ..ops.qp import ADMMSolution
        spec = arrays.ric_pr if pr else arrays.ric
        edt = arrays.A.dtype
        # Cold start each step: cross-step interior-point warm starts were
        # measured LESS robust than cold starts on loss transients (stale
        # active sets stall Mehrotra); the while-loop early exit already
        # prices easy steps cheaply.  warm_state is threaded through for
        # carry-structure stability only.
        if cfg.solver == "ip_hybrid":
            sol, st = ip_riccati_solve_hybrid(
                spec, theta_qp, cfg.N, iters32=cfg.ip_iters,
                iters64=cfg.ip_hybrid_iters, want_state=True)
            st = jax.tree_util.tree_map(
                lambda a: a.astype(jnp.float32), st)
        else:
            sol, st = ip_riccati_solve(
                spec, theta_qp, cfg.N, iters=cfg.ip_iters,
                want_state=True)
        return ADMMSolution(z_primal=sol.z_primal.astype(edt), state=st,
                            r_prim=sol.r_prim.astype(edt),
                            r_dual=sol.r_dual.astype(edt))
    # "admm" and (per-element fallback) "pallas" — identical iteration
    spec = arrays.admm_pr if pr else arrays.admm
    if cfg.iters2 > 0:
        # two-phase rho schedule: phase 1 (tuned rho) drives the
        # primal/active set, phase 2 (rho * rho2_scale) converges the dual
        sol1 = admm_solve(spec, theta_qp, warm_state, iters=cfg.iters)
        spec2 = arrays.admm2_pr if pr else arrays.admm2
        sol = admm_solve(spec2, theta_qp, sol1.state,
                         iters=cfg.iters2, polish=cfg.polish,
                         early_tol=cfg.early_tol,
                         early_dual_factor=cfg.early_dual_factor,
                         check_every=cfg.check_every)
        return _recover(arrays, cfg, sol, pr)
    sol = admm_solve(spec, theta_qp, warm_state,
                     iters=cfg.iters, polish=cfg.polish,
                     early_tol=cfg.early_tol,
                     early_dual_factor=cfg.early_dual_factor,
                     check_every=cfg.check_every)
    return _recover(arrays, cfg, sol, pr)


def _select_extended(cfg, carry, sol, sol_pr):
    """Pick between the normal and packet-received solutions on the
    PREVIOUS step's gamma (driver ordering at
    ``results_linear_system_with_extendedMPC.py:260-378``: gamma is re-drawn
    only after the controller computed its packet)."""
    if not cfg.extended:
        return (sol.z_primal, sol.r_prim, sol.r_dual, sol.state,
                carry.admm_pr)
    use_pr = carry.prev_gamma == 1
    z = jnp.where(use_pr, sol_pr.z_primal, sol.z_primal)
    r_prim = jnp.where(use_pr, sol_pr.r_prim, sol.r_prim)
    r_dual = jnp.where(use_pr, sol_pr.r_dual, sol.r_dual)
    return z, r_prim, r_dual, sol.state, sol_pr.state


def _make_post_solve(arrays, cfg, actuator_mode, robust_estimator,
                     plant_step, infeas_persist):
    """Everything in the per-step protocol AFTER the QP solve, as one pure
    per-element function (vmapped by both engine paths).  ``cert_bad`` is
    the per-step infeasibility-certificate verdict from the solve stage
    (always False when ``infeas_mode=None``)."""

    def post_solve(carry: RolloutCarry, inp, z, r_prim, r_dual,
                   admm_new, admm_pr_new, cert_bad):
        ref_t, w_t, theta_t, gamma_t = inp
        x_hat = carry.est.x_hat
        q_t = carry.est.q
        U_t, x_nom0, xbar = _extract_packet(arrays, cfg, z)

        # --- feasibility detection ---------------------------------------
        # Reference semantics: only the non-robust tracking arm carries a
        # feasibility guard (``track_feasible``,
        # ``results_linear_system.py:262-271``); the robust tube arm cannot
        # go infeasible by design, so ``infeas_mode=None`` (default) only
        # freezes on non-finite iterates.  With ``infeas_mode=
        # "certificate"``, OSQP-style primal/dual infeasibility
        # certificates on the ADMM deltas drive the flag; the
        # ``infeas_persist``-consecutive-steps requirement guards against a
        # borderline certificate flapping for a single step.
        bad_now = jnp.logical_or(cert_bad, ~jnp.isfinite(jnp.sum(z)))
        infeas_count = jnp.where(bad_now, carry.infeas_count + 1,
                                 jnp.zeros((), jnp.int32))
        feasible = jnp.logical_and(
            carry.feasible,
            jnp.logical_and(infeas_count < infeas_persist,
                            jnp.isfinite(jnp.sum(z))))

        # --- estimator records the sent sequence -------------------------
        est1 = store_sequence(carry.est, U_t, x_nom0)

        # --- plant side ---------------------------------------------------
        u_t, plant_pkt, act_new, aux = actuator_step(
            carry.act, U_t, q_t, x_nom0, carry.x, theta_t,
            arrays.A, arrays.B, arrays.K_ss, arrays.K_plant, cfg.N,
            mode=actuator_mode, extended=cfg.extended)

        x_next = plant_step(carry.x, u_t, w_t)

        # --- estimator update on the reply -------------------------------
        est_new = estimator_update(
            est1, plant_pkt, gamma_t, arrays.A, arrays.B, U_t,
            robust=robust_estimator)

        new_carry = RolloutCarry(
            x=x_next, act=act_new, est=est_new,
            admm=admm_new, admm_pr=admm_pr_new,
            prev_gamma=gamma_t, feasible=feasible,
            infeas_count=infeas_count)

        # freeze the element entirely once infeasible (reference stops the
        # arm): keep the old state, but keep advancing timers so indices
        # stay aligned with the scan
        frozen = RolloutCarry(
            x=carry.x,
            act=carry.act._replace(t=carry.act.t + 1),
            est=carry.est._replace(t=carry.est.t + 1),
            admm=carry.admm, admm_pr=carry.admm_pr,
            prev_gamma=gamma_t, feasible=feasible,
            infeas_count=infeas_count)
        out_carry = jax.tree_util.tree_map(
            lambda a, b: jnp.where(feasible, a, b), new_carry, frozen)

        out = StepOutputs(
            x=out_carry.x, u=u_t, x_nom=aux["x_nom"], x_hat=x_hat,
            Theta=aux["Theta"], r_prim=r_prim, r_dual=r_dual,
            feasible=feasible)
        return out_carry, out

    return post_solve


def make_rollout_fn(
    arrays: ControllerArrays,
    cfg: ControllerConfig,
    T: int,
    actuator_mode: str = "consistent",     # "smart" | "consistent"
    robust_estimator: Optional[bool] = None,
    plant_step: Optional[Callable] = None,  # (x, u, w) -> x_next
    infeas_mode: Optional[str] = None,      # None | "certificate"
    infeas_persist: int = 2,
) -> Callable:
    """Build ``rollout(x0, refs, w, theta, gamma) -> (carry, StepOutputs)``.

    ``refs``: (T, nx); ``w``: (T, nx); ``theta``/``gamma``: (T,) int32.
    ``plant_step`` defaults to the linear model ``x+ = A x + B u + w``.
    ``infeas_mode="certificate"`` enables OSQP-style infeasibility
    certificates (for the non-robust tracking arm, matching the
    reference's Clarabel-status arm stop).

    This is the per-element engine (solver "pallas" falls back to the
    numerically equivalent vmapped-XLA ADMM here); ``make_batched_rollout``
    dispatches whole batches to the fused kernel.
    """
    if robust_estimator is None:
        robust_estimator = cfg.extended
    if plant_step is None:
        def plant_step(x, u, w):
            return mm(arrays.A, x) + mm(arrays.B, u) + w
    post_solve = _make_post_solve(arrays, cfg, actuator_mode,
                                  robust_estimator, plant_step,
                                  infeas_persist)

    def step(carry: RolloutCarry, inp):
        ref_t = inp[0]
        theta_qp = jnp.concatenate([carry.est.x_hat, ref_t])
        sol = _solve(arrays, cfg, theta_qp, carry.admm, pr=False)
        sol_pr = (_solve(arrays, cfg, theta_qp, carry.admm_pr, pr=True)
                  if cfg.extended else None)
        z, r_prim, r_dual, admm_new, admm_pr_new = _select_extended(
            cfg, carry, sol, sol_pr)
        if infeas_mode == "certificate" and cfg.solver in (
                "ip_riccati", "ip_hybrid"):
            # structured-IP infeasibility signal: the best-iterate return
            # keeps z finite on infeasible instances (unlike the dense
            # IP, which diverges to NaN), so detection keys on the final
            # scaled primal residual instead — feasible solves land at
            # <=1e-6 (hard-but-feasible transients occasionally exhaust
            # the budget near ~1e-3), infeasible ones stall >=1e-2
            # (measured; a 1e-3 bar falsely stopped 2/200 feasible runs
            # the f64 truth kept)
            cert_bad = sol.r_prim > 1e-2
            if cfg.extended:
                cert_bad = jnp.where(carry.prev_gamma == 1,
                                     sol_pr.r_prim > 1e-2, cert_bad)
        elif infeas_mode == "certificate" and cfg.solver not in (
                "ip", "ip_riccati", "ip_hybrid"):
            # probe with the spec whose rho produced the final state
            cert_spec = arrays.admm2 if cfg.iters2 > 0 else arrays.admm
            pinf, dinf = infeasibility_certificates(
                cert_spec, theta_qp, sol.state)
            cert_bad = jnp.logical_or(pinf, dinf)
            if cfg.extended:
                # certify the QP that was actually USED this step (the
                # reference checks the selected problem's status —
                # ``results_nonlinear_system_with_extendedMPC.py:324``)
                cert_spec_pr = (arrays.admm2_pr if cfg.iters2 > 0
                                else arrays.admm_pr)
                pinf2, dinf2 = infeasibility_certificates(
                    cert_spec_pr, theta_qp, sol_pr.state)
                cert_bad = jnp.where(carry.prev_gamma == 1,
                                     jnp.logical_or(pinf2, dinf2),
                                     cert_bad)
        else:
            cert_bad = jnp.zeros((), bool)
        return post_solve(carry, inp, z, r_prim, r_dual,
                          admm_new, admm_pr_new, cert_bad)

    def rollout(x0, refs, w, theta, gamma, carry0=None):
        if carry0 is None:
            carry0 = init_carry(arrays, cfg, x0, T)
        return jax.lax.scan(step, carry0, (refs, w, theta, gamma))

    return rollout


def _make_pallas_batched_rollout(
    arrays: ControllerArrays,
    cfg: ControllerConfig,
    T: int,
    actuator_mode: str = "consistent",
    robust_estimator: Optional[bool] = None,
    plant_step: Optional[Callable] = None,
    infeas_mode: Optional[str] = None,      # None | "certificate"
    infeas_persist: int = 2,
) -> Callable:
    """Batch-level rollout for ``cfg.solver == "pallas"``: one scan over T
    whose per-step QP solve is the fused ADMM kernel over the WHOLE batch
    (``ops/qp_pallas.py``); the protocol state machines are vmapped around
    it.  Signature matches ``make_batched_rollout``.
    """
    from ..ops.qp import polish_solution
    from ..ops.qp_pallas import admm_solve_pallas

    if robust_estimator is None:
        robust_estimator = cfg.extended
    if plant_step is None:
        def plant_step(x, u, w):
            return mm(arrays.A, x) + mm(arrays.B, u) + w
    post_solve = _make_post_solve(arrays, cfg, actuator_mode,
                                  robust_estimator, plant_step,
                                  infeas_persist)

    def solve_b(spec, spec2, theta_b, state_b, pr=False):
        sol = admm_solve_pallas(spec, theta_b, state_b, iters=cfg.iters,
                                block_b=cfg.pallas_block,
                                interpret=cfg.pallas_interpret)
        if cfg.iters2 > 0:
            # two-phase rho schedule: second kernel pass at rho2
            sol = admm_solve_pallas(spec2, theta_b, sol.state,
                                    iters=cfg.iters2,
                                    block_b=cfg.pallas_block,
                                    interpret=cfg.pallas_interpret)
            spec = spec2
        if cfg.polish:
            def polish_one(th, st, rp, rd):
                q = spec.q0 + mm(spec.Mq, th)
                l = spec.l0 + mm(spec.Ml, th)
                u = spec.u0 + mm(spec.Mu, th)
                xs, rp2, rd2 = polish_solution(
                    spec, q, l, u, st.x, st.y, st.z, rp, rd)
                return spec.D * xs, rp2, rd2
            zp, rp, rd = jax.vmap(polish_one)(
                theta_b, sol.state, sol.r_prim, sol.r_dual)
            sol = sol._replace(z_primal=zp, r_prim=rp, r_dual=rd)
        if cfg.condensed:
            S = arrays.S_rec_pr if (pr and cfg.extended) else arrays.S_rec
            n_red = cfg.n_red_pr if (pr and cfg.extended) else cfg.n_red
            sol = sol._replace(
                z_primal=mm(sol.z_primal[:, :n_red], S.T))
        return sol

    # _select_extended works elementwise on batched leaves except for the
    # scalar-vs-vector `use_pr` broadcast; do the selection batched here.
    def step(carry: RolloutCarry, inp):
        ref_t = inp[0]                                    # (B, nx)
        theta_b = jnp.concatenate([carry.est.x_hat, ref_t], axis=-1)
        sol = solve_b(arrays.admm, arrays.admm2, theta_b, carry.admm)
        if cfg.extended:
            sol_pr = solve_b(arrays.admm_pr, arrays.admm2_pr, theta_b,
                             carry.admm_pr, pr=True)
            use_pr = (carry.prev_gamma == 1)
            z = jnp.where(use_pr[:, None], sol_pr.z_primal, sol.z_primal)
            r_prim = jnp.where(use_pr, sol_pr.r_prim, sol.r_prim)
            r_dual = jnp.where(use_pr, sol_pr.r_dual, sol.r_dual)
            admm_new, admm_pr_new = sol.state, sol_pr.state
        else:
            z, r_prim, r_dual = sol.z_primal, sol.r_prim, sol.r_dual
            admm_new, admm_pr_new = sol.state, carry.admm_pr
        if infeas_mode == "certificate":
            cert_spec = arrays.admm2 if cfg.iters2 > 0 else arrays.admm
            pinf, dinf = jax.vmap(
                lambda th, st: infeasibility_certificates(
                    cert_spec, th, st))(theta_b, sol.state)
            cert_bad = jnp.logical_or(pinf, dinf)
            if cfg.extended:
                cert_spec_pr = (arrays.admm2_pr if cfg.iters2 > 0
                                else arrays.admm_pr)
                pinf2, dinf2 = jax.vmap(
                    lambda th, st: infeasibility_certificates(
                        cert_spec_pr, th, st))(theta_b, sol_pr.state)
                cert_bad = jnp.where(carry.prev_gamma == 1,
                                     jnp.logical_or(pinf2, dinf2),
                                     cert_bad)
        else:
            cert_bad = jnp.zeros(z.shape[0], bool)
        return jax.vmap(post_solve)(carry, inp, z, r_prim, r_dual,
                                    admm_new, admm_pr_new, cert_bad)

    def rollout(x0, refs, w, theta, gamma, carry0=None):
        if carry0 is None:
            carry0 = jax.vmap(lambda x: init_carry(arrays, cfg, x, T))(x0)
        # scan over time with the batch as a trailing axis of each slice
        inputs = (jnp.swapaxes(refs, 0, 1), jnp.swapaxes(w, 0, 1),
                  jnp.swapaxes(theta, 0, 1), jnp.swapaxes(gamma, 0, 1))
        carry, outs = jax.lax.scan(step, carry0, inputs)
        # outputs come out time-major; match the vmapped path (batch-major)
        outs = jax.tree_util.tree_map(
            lambda a: jnp.swapaxes(a, 0, 1), outs)
        return carry, outs

    return rollout


def make_batched_rollout(arrays, cfg, T, **kw) -> Callable:
    """Batched rollout over leading batch axes of all inputs.

    ``cfg.solver == "pallas"`` routes the QP solves through the fused
    ADMM kernel (batch-level dispatch); anything else vmaps the
    per-element engine.
    """
    if cfg.solver == "pallas":
        return _make_pallas_batched_rollout(arrays, cfg, T, **kw)
    fn = make_rollout_fn(arrays, cfg, T, **kw)
    return jax.vmap(fn, in_axes=(0, 0, 0, 0, 0))


def tracking_error_rms(x0, xs, refs, feasible=None):
    """The reference's RMS tracking-error metric
    (``results_linear_system.py:291``):

        1/T * sqrt( sum_t (x_1(t) - ref(t))^2 + sum_{j>=2} x_j(t)^2 )

    over t = 0..T-1 (i.e. including x0, excluding the final state).
    ``xs``: (T, nx) post-step states from the rollout; ``refs``: (T, nx)
    (only the first component is a real reference, the rest are zero).
    Returns NaN where ``feasible`` ended False (reference: NaN + filtering,
    :293-296).
    """
    x0 = jnp.asarray(x0).reshape(1, -1)
    traj = jnp.concatenate([x0, xs[:-1]], axis=0)      # x_0 .. x_{T-1}
    T = traj.shape[0]
    err2 = jnp.sum((traj[:, 0] - refs[:, 0]) ** 2)
    err2 = err2 + jnp.sum(traj[:, 1:] ** 2)
    err = jnp.sqrt(err2) / T
    if feasible is not None:
        err = jnp.where(feasible, err, jnp.nan)
    return err


def make_direct_rollout(
    arrays: ControllerArrays,
    cfg: ControllerConfig,
    T: int,
    ancillary: bool = False,
    plant_step: Optional[Callable] = None,
) -> Callable:
    """Non-networked closed loop: solve the QP from the *measured* state and
    apply its first input every step — the loops of
    ``Example_of_Regulator_MPC.py:46-62``, ``Example_of_Tracking_MPC.py:65-81``
    (``ancillary=False``: u = u*_0) and ``Example_of_Tube_Regulator_MPC.py`` /
    ``Example_of_Tube_Tracking_MPC.py:77-106`` (``ancillary=True``:
    u = u*_0 - K (x - x*_nom0), Mayne's tube law).

    Returns ``rollout(x0, refs, w) -> (carry, outs)`` with outs
    ``(x, u, x_nom0, xbar, r_prim, r_dual)``; vmap for batches.
    """
    if plant_step is None:
        def plant_step(x, u, w):
            return mm(arrays.A, x) + mm(arrays.B, u) + w

    def step(carry, inp):
        x, admm_state = carry
        ref_t, w_t = inp
        theta_qp = jnp.concatenate([x, ref_t])
        sol = _solve(arrays, cfg, theta_qp, admm_state)
        z = sol.z_primal
        u0 = z[cfg.u_off:cfg.u_off + cfg.nu]
        x_nom0 = z[:cfg.nx]
        if ancillary:
            u = u0 - mm(arrays.K_plant, x - x_nom0)
        else:
            u = u0
        if cfg.tracking:
            xbar = z[cfg.xbar_off:cfg.xbar_off + cfg.nx]
        else:
            xbar = jnp.zeros(cfg.nx, z.dtype)
        x_next = plant_step(x, u, w_t)
        return (x_next, sol.state), (x_next, u, x_nom0, xbar,
                                     sol.r_prim, sol.r_dual)

    def rollout(x0, refs, w):
        x0 = jnp.asarray(x0, arrays.A.dtype).reshape(cfg.nx)
        if cfg.solver in ("ip_riccati", "ip_hybrid"):
            from ..ops.ip_riccati import init_ip_state
            sdt = jnp.float32 if cfg.solver == "ip_hybrid" else None
            warm = init_ip_state(arrays.ric, cfg.N, dtype=sdt)
        else:
            warm = init_admm_state(arrays.admm)
        carry0 = (x0, warm)
        return jax.lax.scan(step, carry0, (refs, w))

    return rollout
