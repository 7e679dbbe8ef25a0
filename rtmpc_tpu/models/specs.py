"""Controller setup: the reference's five MPC classes as frozen specs.

The reference implements a class hierarchy (``RegulatorMPC`` ->
``TrackingMPC``; ``RegulatorMPC`` -> ``TubeRegulatorMPC`` ->
``TubeTrackingMPC`` -> ``ExtendedTubeTrackingMPC``) whose ``setup_*`` methods
mutate internal CVXPY state.  Here each variant is a pure host-side setup
function returning an ``MPCSetup`` (float64 artifacts: gains, sets, QP
template) plus ``to_device`` to freeze everything into a static-shape pytree
(``ControllerArrays``) + hashable static config (``ControllerConfig``) for
the jitted rollout engine.

Variant-by-variant parity notes (file:line refer to /root/reference):

* Regulator  — ``RegulatorMPC.py:45-76``: no terminal cost/set (the
  reference's own TODO at :74), state rows on x_0..x_{N-1}.
* Tracking   — ``TrackingMPC.py:19-199``: LQR gain K, Lyapunov terminal
  cost ``P = dlyap(Acl, Q + K'RK)``, offset cost ``Tout = 10 P``, terminal
  set = Gilbert-Tan maximal admissible set of the augmented
  (x, xbar, ubar) system with lambda-contracted constraints (:160-186).
* TubeRegulator — ``TubeRegulatorMPC.py``: mRPI Z (Rakovic or Darup),
  tightened sets ``Xc = X - Z``, ``Uc = U - (-K)Z``, terminal set via
  Gilbert-Tan on the tightened (x, u=-Kx) polytope, initial-state tube.
* TubeTracking — ``TubeTrackingMPC.py``: tube machinery + tracking block;
  optional separate ancillary gain (:229-231); initial state fixed
  (paper eq. (8d)) or tube-relaxed (:125-132).
* ExtendedTubeTracking — ``TubeTrackingMPC.py:249-369``: a second QP for
  the packet-received case with initial tube ``Z - W``.  The reference's
  terminal constraint for that QP is vacuous due to a variable-aliasing bug
  (it binds the *other* problem's variables, :293).  We implement the
  corrected constraint by default and expose ``compat_reference_bug=True``
  to reproduce the reference behaviour (terminal constraint dropped).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.polytope import Polytope, pont_diff
from ..utils.synthesis import dlqr, dlyap
from ..sets.invariant import determine_mrpi, max_admissible_set, \
    tighten_constraints
from ..ops.assembly import QPTemplate, build_mpc_qp, condense_template
from ..ops.qp import ADMMSpec, prepare_admm
from ..ops.ip import IPSpec, prepare_ip
from ..ops.ip_riccati import RiccatiIPSpec, prepare_ip_riccati

__all__ = [
    "MPCSetup", "ControllerArrays", "ControllerConfig",
    "setup_regulator", "setup_tracking", "setup_tube_regulator",
    "setup_tube_tracking", "setup_extended_tube_tracking",
]


# ---------------------------------------------------------------------------
# Host-side setup product
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MPCSetup:
    """Everything the setup phase produces, in float64 on the host."""
    kind: str                       # regulator|tracking|tube_regulator|...
    A: np.ndarray
    B: np.ndarray
    Q: np.ndarray
    R: np.ndarray
    N: int
    K: Optional[np.ndarray] = None          # steady-state (LQR) gain
    P: Optional[np.ndarray] = None          # terminal cost
    Tout: Optional[np.ndarray] = None       # offset cost (10 P)
    K_ancillary: Optional[np.ndarray] = None
    X: Optional[Polytope] = None
    U: Optional[Polytope] = None
    W: Optional[Polytope] = None
    Z: Optional[Polytope] = None            # mRPI tube cross-section
    Xc: Optional[Polytope] = None
    Uc: Optional[Polytope] = None
    Xf: Optional[Polytope] = None           # terminal set
    template: Optional[QPTemplate] = None
    template_pr: Optional[QPTemplate] = None  # extended: packet-received QP
    fixed_initial_state: bool = False
    lambda_param: float = 0.99999

    @property
    def nx(self) -> int:
        return self.A.shape[1]

    @property
    def nu(self) -> int:
        return self.B.shape[1]

    def ancillary_gain(self) -> np.ndarray:
        """``get_ancillary_controller_gain`` (``TubeTrackingMPC.py:233-238``)."""
        return self.K if self.K_ancillary is None else self.K_ancillary

    # ------------------------------------------------------------------
    def to_device(self, dtype=jnp.float32, pad_to: int = 8,
                  iters: int = 100, iters2: int = 0,
                  rho2_scale: float = 0.1,
                  rho="auto", polish: bool = False,
                  solver: str = "admm", ip_iters: int = 25,
                  ip_hybrid_iters: int = 12,
                  probe_thetas: Optional[np.ndarray] = None,
                  pallas_block: int = 16,
                  pallas_interpret: bool = False,
                  early_tol: Optional[float] = None,
                  early_dual_factor: float = 25.0,
                  check_every: int = 25,
                  condensed: bool = False,
                  **admm_kw):
        """Freeze into (ControllerArrays, ControllerConfig) for the engine.

        ``solver``: "admm" (throughput mode — shared factorization,
        warm-started, vmapped XLA iteration), "pallas" (same ADMM run as
        one fused GPU kernel over the whole batch — the batched rollout
        path only; per-element code paths fall back to "admm" semantics),
        or "ip" (accuracy mode — batched Mehrotra interior
        point, Clarabel-class residuals on every instance, one dense
        factorization per instance per iteration).

        ``pallas_block``: instances per kernel block (solver "pallas").  ``pallas_interpret``: run the kernel in interpreter
        mode (CPU testing only).
        """
        tmpl = self.template
        tmpl_pr = self.template_pr
        if condensed:
            # state-eliminated (strictly convex, dynamics-row-free)
            # reformulation — see ``ops/assembly.py:condense_template``;
            # solutions are recovered to the full layout via S in _solve
            tmpl = condense_template(tmpl)
            if tmpl_pr is not None:
                tmpl_pr = condense_template(tmpl_pr)
        # tune rho at (roughly) the iteration budget the engine will use
        admm_kw.setdefault("tune_iters", max(100, min(iters + iters2, 600)))
        r2s = rho2_scale if iters2 > 0 else None
        admm = prepare_admm(tmpl, rho=rho, pad_to=pad_to, dtype=dtype,
                            probe_thetas=probe_thetas, rho2_scale=r2s,
                            **admm_kw)
        admm, admm2 = admm if iters2 > 0 else (admm, admm)
        if tmpl_pr is not None:
            admm_pr = prepare_admm(tmpl_pr, rho=rho, pad_to=pad_to,
                                   dtype=dtype, probe_thetas=probe_thetas,
                                   rho2_scale=r2s, **admm_kw)
            admm_pr, admm2_pr = (admm_pr if iters2 > 0
                                 else (admm_pr, admm_pr))
        else:
            admm_pr, admm2_pr = admm, admm2  # identical structure
        ip = prepare_ip(tmpl, pad_to=pad_to, dtype=dtype)
        ip_pr = (prepare_ip(tmpl_pr, pad_to=pad_to, dtype=dtype)
                 if tmpl_pr is not None else ip)
        # structured (Riccati/arrowhead) IP: built from the UNCONDENSED
        # templates — the stage structure is the whole point.  Templates
        # predating row_meta (or using the x_N == xbar fallback) simply
        # don't get the fast path.  The mixed-precision hybrid carries
        # the f64 spec regardless of engine dtype (phase 1 casts down).
        ric_dtype = jnp.float64 if solver == "ip_hybrid" else dtype
        if solver == "ip_hybrid":
            import jax as _jax
            assert _jax.config.jax_enable_x64, \
                "solver='ip_hybrid' needs jax_enable_x64 (f64 polish phase)"
        try:
            ric = prepare_ip_riccati(self.template, dtype=ric_dtype)
            ric_pr = (prepare_ip_riccati(self.template_pr, dtype=ric_dtype)
                      if self.template_pr is not None else ric)
        except AssertionError:
            if solver in ("ip_riccati", "ip_hybrid"):
                raise
            ric = ric_pr = None

        nx, nu, N = self.nx, self.nu, self.N
        K = self.K if self.K is not None else np.zeros((nu, nx))
        Kp = self.ancillary_gain() if self.kind.startswith("tube") else K

        # Tube cross-section H-rep for on-device membership checks, padded.
        if self.Z is not None:
            Hz, hz = self.Z.A, self.Z.b
        else:
            Hz, hz = np.zeros((1, nx)), np.ones(1)
        mz = ((Hz.shape[0] + pad_to - 1) // pad_to) * pad_to
        Hz_p = np.zeros((mz, nx))
        hz_p = np.ones(mz)
        Hz_p[:Hz.shape[0]] = Hz
        hz_p[:hz.shape[0]] = hz

        arrays = ControllerArrays(
            admm=admm,
            admm_pr=admm_pr,
            ip=ip,
            ip_pr=ip_pr,
            A=jnp.asarray(self.A, dtype),
            B=jnp.asarray(self.B, dtype),
            K_ss=jnp.asarray(K, dtype),
            K_plant=jnp.asarray(Kp, dtype),
            Hz=jnp.asarray(Hz_p, dtype),
            hz=jnp.asarray(hz_p, dtype),
            admm2=admm2,
            admm2_pr=admm2_pr,
            S_rec=(jnp.asarray(tmpl.S, dtype) if condensed
                   else jnp.zeros((0, 0), dtype)),
            S_rec_pr=(jnp.asarray(tmpl_pr.S, dtype)
                      if condensed and tmpl_pr is not None
                      else jnp.zeros((0, 0), dtype)),
            ric=ric,
            ric_pr=ric_pr,
        )
        cfg = ControllerConfig(
            nx=nx, nu=nu, N=N,
            n=self.template.n,        # FULL layout size (tmpl may be condensed)
            tracking=tmpl.tracking,
            extended=self.template_pr is not None,
            iters=iters,
            iters2=iters2,
            polish=polish,
            solver=solver,
            ip_iters=ip_iters,
            ip_hybrid_iters=ip_hybrid_iters,
            u_off=nx * (N + 1),
            xbar_off=(nx * (N + 1) + nu * N) if tmpl.tracking else -1,
            ubar_off=(nx * (N + 1) + nu * N + nx) if tmpl.tracking else -1,
            pallas_block=pallas_block,
            pallas_interpret=pallas_interpret,
            early_tol=early_tol,
            early_dual_factor=early_dual_factor,
            check_every=check_every,
            condensed=condensed,
            n_red=tmpl.n if condensed else 0,
            n_red_pr=(tmpl_pr.n if condensed and tmpl_pr is not None
                      else 0),
        )
        return arrays, cfg


class ControllerArrays(NamedTuple):
    """Device pytree: everything the jitted per-step function reads."""
    admm: ADMMSpec
    admm_pr: ADMMSpec          # extended-MPC packet-received problem
    ip: IPSpec                 # interior-point (accuracy mode) problem data
    ip_pr: IPSpec
    A: jax.Array               # (nx, nx) plant/nominal model
    B: jax.Array               # (nx, nu)
    K_ss: jax.Array            # (nu, nx) steady-state gain (terminal law)
    K_plant: jax.Array         # (nu, nx) ancillary gain
    Hz: jax.Array              # (mz_p, nx) tube H-rep (padded)
    hz: jax.Array              # (mz_p,)
    # Two-phase rho schedule (ops/qp.py:prepare_admm rho2_scale): phase-2
    # specs (rho/10 K^{-1} + composites).  Alias of admm/admm_pr when the
    # schedule is disabled (cfg.iters2 == 0) so the pytree structure is
    # stable.
    admm2: ADMMSpec = None
    admm2_pr: ADMMSpec = None
    # Condensed-form recovery: z_full = S_rec @ v_red (empty (0,0) array
    # when cfg.condensed is False — pytree-stable placeholder)
    S_rec: jax.Array = None
    S_rec_pr: jax.Array = None
    # Structured interior point (solver "ip_riccati"); None when the
    # template lacks stage metadata (None is an empty pytree node)
    ric: RiccatiIPSpec = None
    ric_pr: RiccatiIPSpec = None


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Hashable static metadata for jit."""
    nx: int
    nu: int
    N: int
    n: int
    tracking: bool
    extended: bool
    iters: int
    polish: bool
    solver: str
    ip_iters: int
    # f64 polish-phase budget for solver "ip_hybrid" (while-loop bounded:
    # easy/warm lanes exit early, so this is a cap, not a cost)
    ip_hybrid_iters: int
    u_off: int
    xbar_off: int
    ubar_off: int
    pallas_block: int = 16
    pallas_interpret: bool = False
    # Residual-based early exit of the ADMM loop (ops/qp.py:admm_solve):
    # None = fixed iteration count; a float = scaled-residual tolerance at
    # which warm-started steps stop early (iters stays the hard budget).
    early_tol: Optional[float] = None
    early_dual_factor: float = 25.0
    check_every: int = 25
    # Two-phase rho schedule: phase-2 iteration count (0 = disabled);
    # phase 2 runs on arrays.admm2 (rho scaled by to_device's rho2_scale).
    iters2: int = 0
    # Condensed (state-eliminated) solving: solvers run in the reduced
    # space (n_red unpadded reduced vars); _solve maps back to the full
    # layout via arrays.S_rec so all packet/extraction offsets hold.
    condensed: bool = False
    n_red: int = 0
    n_red_pr: int = 0


# ---------------------------------------------------------------------------
# Gain/terminal-cost synthesis shared by tracking/tube variants
# ---------------------------------------------------------------------------

def _lqr_terminal(A, B, Q, R):
    """K, P, Acl exactly as the reference (``TrackingMPC.py:25-31``):
    ``K`` from dlqr; ``P = dlyap(Acl, sym(Q + K'RK))``."""
    K, _, _ = dlqr(A, B, Q, R)
    Qlyap = Q + K.T @ R @ K
    Qlyap = (Qlyap + Qlyap.T) / 2
    Acl = A - B @ K
    P = dlyap(Acl, Qlyap)
    return K, P, Acl


def _augmented_terminal_set(Acl, A, B, K, X: Polytope, U: Polytope,
                            lam: float) -> Polytope:
    """Gilbert–Tan terminal set of the augmented (x, xbar, ubar) system.

    ``TrackingMPC.determine_Xf`` (:160-186) / ``TubeTrackingMPC.determine_Xf``
    (:35-61), generalized to arbitrary H-rep row counts (the reference
    hardcodes the 2nx/2nu box structure).

    Augmented dynamics  A_e = [[Acl, BK, B], [0, I, 0], [0, 0, I]];
    constraint rows: x in X;  ubar + K(xbar - x) in U;  xbar in lam X;
    ubar in lam U.
    """
    nx = A.shape[1]
    nu = B.shape[1]
    Hx, hx = X.A, X.b
    Hu, hu = U.A, U.b
    A_e = np.block([
        [Acl, B @ K, B],
        [np.zeros((nx, nx)), np.eye(nx), np.zeros((nx, nu))],
        [np.zeros((nu, nx)), np.zeros((nu, nx)), np.eye(nu)],
    ])
    Hcl = np.block([
        [Hx, np.zeros((Hx.shape[0], nx)), np.zeros((Hx.shape[0], nu))],
        [-Hu @ K, Hu @ K, Hu],
        [np.zeros((Hx.shape[0], nx)), Hx, np.zeros((Hx.shape[0], nu))],
        [np.zeros((Hu.shape[0], nx)), np.zeros((Hu.shape[0], nx)), Hu],
    ])
    hcl = np.concatenate([hx, hu, lam * hx, lam * hu])
    return max_admissible_set(A_e, Polytope(Hcl, hcl))


# ---------------------------------------------------------------------------
# The five controller variants
# ---------------------------------------------------------------------------

def setup_regulator(A, B, Q, R, N, X: Optional[Polytope] = None,
                    U: Optional[Polytope] = None) -> MPCSetup:
    """RegulatorMPC (``RegulatorMPC.py``): regulate to the origin, no
    terminal ingredients (matching the reference's TODO at :74)."""
    A, B = np.asarray(A, float), np.asarray(B, float)
    Q, R = np.asarray(Q, float), np.atleast_2d(np.asarray(R, float))
    tmpl = build_mpc_qp(
        A, B, Q, R, N,
        Hx=None if X is None else X.A, hx=None if X is None else X.b,
        Hu=None if U is None else U.A, hu=None if U is None else U.b,
        init_mode="fixed")
    return MPCSetup(kind="regulator", A=A, B=B, Q=Q, R=R, N=int(N),
                    X=X, U=U, template=tmpl, fixed_initial_state=True)


def setup_tracking(A, B, Q, R, N, X: Polytope, U: Polytope,
                   lambda_param: float = 0.99999,
                   use_terminal_set: bool = True) -> MPCSetup:
    """TrackingMPC (Limon 2008 / Pezzutto 2022): artificial steady state,
    Lyapunov terminal cost, Gilbert–Tan augmented terminal set."""
    A, B = np.asarray(A, float), np.asarray(B, float)
    Q, R = np.asarray(Q, float), np.atleast_2d(np.asarray(R, float))
    K, P, Acl = _lqr_terminal(A, B, Q, R)
    Tout = 10 * P
    Xf = (_augmented_terminal_set(Acl, A, B, K, X, U, lambda_param)
          if use_terminal_set else None)
    tmpl = build_mpc_qp(
        A, B, Q, R, N, tracking=True, P_term=P, Tout=Tout,
        Hx=X.A, hx=X.b, Hu=U.A, hu=U.b,
        HxN=None if Xf is None else Xf.A,
        hxN=None if Xf is None else Xf.b,
        terminal_augmented=Xf is not None,
        init_mode="fixed")
    return MPCSetup(kind="tracking", A=A, B=B, Q=Q, R=R, N=int(N), K=K, P=P,
                    Tout=Tout, X=X, U=U, Xf=Xf, template=tmpl,
                    fixed_initial_state=True, lambda_param=lambda_param)


def _tube_common(A, B, Q, R, W, X, U, eps_var, rpi_method, K_ancillary):
    """Shared tube machinery: gains, mRPI (with the ancillary closed loop if
    one is given, ``TubeTrackingMPC.determine_mRPI`` :63-88), tightening."""
    K, P, Acl = _lqr_terminal(A, B, Q, R)
    if K_ancillary is not None:
        K_anc = np.atleast_2d(np.asarray(K_ancillary, float))
        Acl_plant = A - B @ K_anc
    else:
        K_anc, Acl_plant = K, Acl
    Z = determine_mrpi(Acl_plant, W, X=X, U=U, K=K_anc,
                       eps_var=eps_var, rpi_method=rpi_method)
    Xc, Uc = tighten_constraints(X, U, Z, K_anc)
    return K, P, Acl, K_anc, Z, Xc, Uc


def setup_tube_regulator(A, B, Q, R, N, X: Polytope, U: Polytope,
                         W: Polytope, eps_var: float = 1.9e-5,
                         rpi_method: int = 0) -> MPCSetup:
    """TubeRegulatorMPC (Mayne 2005): tightened constraints, terminal set on
    the tightened (x, -Kx) polytope, initial-state tube."""
    A, B = np.asarray(A, float), np.asarray(B, float)
    Q, R = np.asarray(Q, float), np.atleast_2d(np.asarray(R, float))
    K, P, Acl, _, Z, Xc, Uc = _tube_common(
        A, B, Q, R, W, X, U, eps_var, rpi_method, None)
    # terminal set: Gilbert-Tan on tightened XU with u = -Kx
    # (``TubeRegulatorMPC.determine_Xf`` :91-107)
    Gxu = np.vstack([Xc.A, -Uc.A @ K])
    fxu = np.concatenate([Xc.b, Uc.b])
    Xf = max_admissible_set(Acl, Polytope(Gxu, fxu))
    tmpl = build_mpc_qp(
        A, B, Q, R, N, P_term=P,
        Hx=Xc.A, hx=Xc.b, Hu=Uc.A, hu=Uc.b,
        HxN=Xf.A, hxN=Xf.b,
        init_mode="tube", Hz=Z.A, hz=Z.b)
    return MPCSetup(kind="tube_regulator", A=A, B=B, Q=Q, R=R, N=int(N),
                    K=K, P=P, X=X, U=U, W=W, Z=Z, Xc=Xc, Uc=Uc, Xf=Xf,
                    template=tmpl)


def setup_tube_tracking(A, B, Q, R, N, X: Polytope, U: Polytope, W: Polytope,
                        fixed_initial_state: bool = False,
                        rpi_method: int = 0, eps_var: float = 1e-4,
                        K_ancillary: Optional[np.ndarray] = None,
                        lambda_param: float = 0.99999) -> MPCSetup:
    """TubeTrackingMPC (Limon 2010 x Umsonst-Barbosa 2024): the flagship."""
    A, B = np.asarray(A, float), np.asarray(B, float)
    Q, R = np.asarray(Q, float), np.atleast_2d(np.asarray(R, float))
    K, P, Acl, K_anc, Z, Xc, Uc = _tube_common(
        A, B, Q, R, W, X, U, eps_var, rpi_method, K_ancillary)
    Tout = 10 * P
    Xf = _augmented_terminal_set(Acl, A, B, K, Xc, Uc, lambda_param)
    tmpl = build_mpc_qp(
        A, B, Q, R, N, tracking=True, P_term=P, Tout=Tout,
        Hx=Xc.A, hx=Xc.b, Hu=Uc.A, hu=Uc.b,
        HxN=Xf.A, hxN=Xf.b, terminal_augmented=True,
        init_mode="fixed" if fixed_initial_state else "tube",
        Hz=Z.A, hz=Z.b)
    return MPCSetup(kind="tube_tracking", A=A, B=B, Q=Q, R=R, N=int(N),
                    K=K, P=P, Tout=Tout,
                    K_ancillary=None if K_ancillary is None else K_anc,
                    X=X, U=U, W=W, Z=Z, Xc=Xc, Uc=Uc, Xf=Xf, template=tmpl,
                    fixed_initial_state=fixed_initial_state,
                    lambda_param=lambda_param)


def setup_extended_tube_tracking(A, B, Q, R, N, X: Polytope, U: Polytope,
                                 W: Polytope,
                                 fixed_initial_state: bool = False,
                                 rpi_method: int = 0, eps_var: float = 1e-4,
                                 K_ancillary: Optional[np.ndarray] = None,
                                 lambda_param: float = 0.99999,
                                 compat_reference_bug: bool = False
                                 ) -> MPCSetup:
    """ExtendedTubeTrackingMPC (paper Section IV.F): two QPs — the normal
    tube-tracking problem plus a packet-received variant whose initial tube
    is shrunk to ``Z - W`` (``TubeTrackingMPC.py:265-267``).

    ``compat_reference_bug=True`` reproduces the reference's vacuous
    terminal constraint in the packet-received problem (its eq at :293
    references the *other* problem's CVXPY variables, so the constraint
    never binds); the default applies the corrected constraint.
    """
    setup = setup_tube_tracking(
        A, B, Q, R, N, X, U, W,
        fixed_initial_state=fixed_initial_state, rpi_method=rpi_method,
        eps_var=eps_var, K_ancillary=K_ancillary, lambda_param=lambda_param)
    ZmW = pont_diff(setup.Z, W)
    if np.any(ZmW.b < 0):
        raise ValueError("Z - W is empty: the disturbance set is too large "
                         "relative to the tube for the extended MPC")
    tmpl_pr = build_mpc_qp(
        np.asarray(A, float), np.asarray(B, float),
        np.asarray(Q, float), np.atleast_2d(np.asarray(R, float)), N,
        tracking=True, P_term=setup.P, Tout=setup.Tout,
        Hx=setup.Xc.A, hx=setup.Xc.b, Hu=setup.Uc.A, hu=setup.Uc.b,
        HxN=None if compat_reference_bug else setup.Xf.A,
        hxN=None if compat_reference_bug else setup.Xf.b,
        terminal_augmented=not compat_reference_bug,
        init_mode="tube", Hz=ZmW.A, hz=ZmW.b)
    if compat_reference_bug:
        # The reference's packet-received problem keeps x_N free of any
        # terminal coupling; build_mpc_qp would add x_N == xbar when no
        # terminal set is given, so strip that equality to mimic the bug.
        neq = tmpl_pr.m - setup.nx
        tmpl_pr = dataclasses.replace(
            tmpl_pr,
            A=tmpl_pr.A[:neq], l0=tmpl_pr.l0[:neq], u0=tmpl_pr.u0[:neq],
            Ml=tmpl_pr.Ml[:neq], Mu=tmpl_pr.Mu[:neq],
            is_eq=tmpl_pr.is_eq[:neq],
            row_meta={**tmpl_pr.row_meta, "terminal_eq_fallback": False,
                      "mN": 0})
    return dataclasses.replace(setup, kind="extended_tube_tracking",
                               template_pr=tmpl_pr)
