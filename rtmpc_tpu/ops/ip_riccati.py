"""Structure-exploiting batched interior point: Riccati/arrowhead KKT solve.

The accuracy-mode solver in ``ops/ip.py`` factorizes the FLAT KKT matrix
(~200x200 for the 4-D N=20 cartpole) with a dense LU every Mehrotra
iteration; a batched 200x200 LU is a long sequential pivot chain that
dominates its runtime.  This module solves the SAME Newton
systems without ever forming the flat matrix, exploiting the MPC QP's
stagewise structure (the reference hands the same structure to Clarabel
blind, ``TrackingMPC.py:64-130``; SURVEY.md section 2.1):

* stage variables (x_k, u_k) couple only through the dynamics equalities
  ``x_{k+1} = A x_k + B u_k`` -> the stage-stage KKT block is
  block-tridiagonal and solved by a backward/forward Riccati sweep
  (``lax.scan`` over N stages of (nx+nu)-sized ops: O(N (nx+nu)^3) flops
  vs O((n+me)^3) for the dense LU — ~50x fewer on the cartpole, and a
  ~10x shorter sequential dependency chain, which is what actually
  matters for batched factorizations);
* the tracking block w = (xbar, ubar) couples to every stage through the
  cost and to x_N through the augmented terminal set -> an arrowhead
  border, eliminated by a (nw + nss)-sized Schur complement whose columns
  are nw extra Riccati back-solves sharing the factorization.

Inequality rows enter through the standard primal-dual elimination as
stagewise diagonal weights (state/input rows stay per-stage; the ~500-row
augmented terminal set becomes one (nx+nw)^2 dense contribution built by
a small matmul), so the Mehrotra algebra is IDENTICAL to ``ops/ip.py``
— same central path, same freeze-on-convergence — only the linear solves
change.

Row layout consumed from ``QPTemplate.row_meta`` (``ops/assembly.py``):
[dynamics | init (fixed eq / tube ineq) | ss eq | state | input | terminal].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .assembly import QPTemplate
from .ip import IPSolution
from .precision import HIGHEST

__all__ = ["RiccatiIPSpec", "prepare_ip_riccati", "ip_riccati_solve"]


def _es(sub, *ops):
    return jnp.einsum(sub, *ops, precision=HIGHEST)


def _mm(a, b):
    return jnp.matmul(a, b, precision=HIGHEST)


# ---------------------------------------------------------------------------
# Hand-rolled small-SPD Cholesky (unrolled at trace time).
#
# Every linear solve in this solver is a tiny SPD system (nu x nu stage
# feedback, nx x nx free-initial-state, nw x nw / nss x nss Schur blocks —
# all <= 9).  A library batched LU is a sequential pivot loop per matrix;
# these unrolled loops compile to straight-line mul/add/div/sqrt in any
# dtype, which keeps the f32 and f64 phases of the accuracy mode on the
# same code.
# ---------------------------------------------------------------------------

def _chol(A):
    """Lower-triangular Cholesky of a small SPD matrix ([..., n, n]).

    The pivot is floored at a relative epsilon of the diagonal scale:
    near-singular blocks (soft tracking modes at late barrier stages)
    then factor to a nearby PD matrix instead of NaN, and the Newton
    refinement pass absorbs the perturbation.
    """
    n = A.shape[-1]
    eps = jnp.asarray(jnp.finfo(A.dtype).eps, A.dtype)
    rows = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[..., j, j]
        for k in range(j):
            d = d - rows[j][k] * rows[j][k]
        d = jnp.maximum(d, eps * (jnp.abs(A[..., j, j]) + 1.0))
        dj = jnp.sqrt(d)
        rows[j][j] = dj
        inv = 1.0 / dj
        for i in range(j + 1, n):
            v = A[..., i, j]
            for k in range(j):
                v = v - rows[i][k] * rows[j][k]
            rows[i][j] = v * inv
    return rows


def _plu_factor(A):
    """Partially-pivoted LU of a small matrix ([..., n, n]), unrolled.

    Compiles to straight-line mul/add/div + one-hot selects — no library
    LU call.  Pivoting preserves the sign
    structure of indefinite blocks (a clamped Cholesky silently flips
    near-zero pivots, which was measured to stall the IP on hard
    transients).  Returns (LU_compact, perm_onehots).
    """
    n = A.shape[-1]
    M = A
    perms = []
    big = jnp.asarray(jnp.finfo(A.dtype).max, A.dtype)
    for k in range(n):
        col = jnp.abs(M[..., :, k])
        if k:
            mask = jnp.arange(n) < k
            col = jnp.where(mask, -big, col)
        p = jnp.argmax(col, axis=-1)
        oh = jax.nn.one_hot(p, n, dtype=A.dtype)          # [..., n]
        ek = jnp.zeros(n, A.dtype).at[k].set(1.0)
        rowp = _es('...i,...ij->...j', oh, M)
        rowk = M[..., k, :]
        M = M + (ek - oh)[..., :, None] * (rowp - rowk)[..., None, :]
        perms.append(oh)
        piv = M[..., k, k]
        below = (jnp.arange(n) > k).astype(A.dtype)
        fac = below * M[..., :, k] / piv[..., None]
        # eliminate columns >= k only — columns < k hold the already-
        # stored multipliers of earlier steps and must stay untouched
        colmask = (jnp.arange(n) >= k).astype(A.dtype)
        M = M - fac[..., :, None] * (M[..., k, :] * colmask)[..., None, :]
        # compact storage: multipliers live below the diagonal in column k
        M = M + fac[..., :, None] * ek[None, :]
    return M, perms


def _plu_solve(fac, b):
    """Solve A x = b from ``_plu_factor``; b: [..., n] or [..., n, m]."""
    M, perms = fac
    n = M.shape[-1]
    vec = b.ndim == M.ndim - 1
    if vec:
        b = b[..., None]
    # apply permutations in order
    for k, oh in enumerate(perms):
        ek = jnp.zeros(n, b.dtype).at[k].set(1.0)
        rowp = _es('...i,...im->...m', oh, b)
        rowk = b[..., k, :]
        b = b + (ek - oh)[..., :, None] * (rowp - rowk)[..., None, :]
    # forward: L has unit diagonal, multipliers stored below
    y = [None] * n
    for i in range(n):
        v = b[..., i, :]
        for kk in range(i):
            v = v - M[..., i, kk][..., None] * y[kk]
        y[i] = v
    x = [None] * n
    for i in reversed(range(n)):
        v = y[i]
        for kk in range(i + 1, n):
            v = v - M[..., i, kk][..., None] * x[kk]
        x[i] = v / M[..., i, i][..., None]
    out = jnp.stack(x, axis=-2)
    return out[..., 0] if vec else out


def _chol_solve(rows, b):
    """Solve L L' x = b given ``rows`` from ``_chol``; b: [..., n] or
    [..., n, m] (trailing RHS axis)."""
    n = len(rows)
    vec = b.ndim == rows[0][0].ndim + 1
    get = (lambda i: b[..., i]) if vec else (lambda i: b[..., i, :])
    lk = (lambda i, j: rows[i][j]) if vec \
        else (lambda i, j: rows[i][j][..., None])
    y = [None] * n
    for i in range(n):
        v = get(i)
        for k in range(i):
            v = v - lk(i, k) * y[k]
        y[i] = v / lk(i, i)
    x = [None] * n
    for i in reversed(range(n)):
        v = y[i]
        for k in range(i + 1, n):
            v = v - lk(k, i) * x[k]
        x[i] = v / lk(i, i)
    return jnp.stack(x, axis=-1 if vec else -2)


class RiccatiIPSpec(NamedTuple):
    """Device pytree of the stage-structured IP problem.

    Cost matrices carry the template's 1/2 z'Pz convention (stage blocks
    are 2Q etc.) scaled by a scalar ``c_obj`` for f32 headroom; inequality
    rows are 2-norm-equilibrated.  Neither scaling changes the primal.
    Static structure is shape-encoded: ``Ht.shape[0] == 0`` <=> fixed
    initial state; ``Hww.shape[0] == 0`` <=> no tracking block;
    ``GN.shape[0] == 0`` <=> no terminal rows.
    """
    A: jax.Array       # (nx, nx) dynamics
    B: jax.Array       # (nx, nu)
    Qx: jax.Array      # (nx, nx) stage state cost block (2Q, scaled)
    Ru: jax.Array      # (nu, nu) stage input cost block (2R, scaled)
    QN: jax.Array      # (nx, nx) terminal cost block
    Cxw: jax.Array     # (nx, nw) stage x_k <-> w cost coupling
    Cuw: jax.Array     # (nu, nw) stage u_k <-> w cost coupling
    CNw: jax.Array     # (nx, nw) terminal x_N <-> w cost coupling
    Hww: jax.Array     # (nw, nw) w cost block
    qw0: jax.Array     # (nw,)
    Mqw: jax.Array     # (nw, ntheta)  qw = qw0 + Mqw theta
    Ass: jax.Array     # (nss, nw) steady-state equality rows (b = 0)
    b00: jax.Array     # (nx,) fixed-init b = b00 + Mb0 theta
    Mb0: jax.Array     # (nx, ntheta)
    Hx: jax.Array      # (mx, nx) stage state rows (theta-independent h)
    hx: jax.Array      # (mx,)
    Hu: jax.Array      # (mu, nu)
    hu: jax.Array      # (mu,)
    Ht: jax.Array      # (mt, nx) initial-tube rows on x_0
    ht0: jax.Array     # (mt,)
    Mht: jax.Array     # (mt, ntheta)
    GN: jax.Array      # (mN, nx) terminal rows, x_N part
    GNw: jax.Array     # (mN, nw) terminal rows, w part
    hN: jax.Array      # (mN,)
    c_obj: jax.Array   # () cost scaling applied at prep
    Sx: jax.Array      # (nx,) variable scaling: x_template = Sx * x_internal
    Su: jax.Array      # (nu,)


def prepare_ip_riccati(template: QPTemplate,
                       dtype=jnp.float32) -> RiccatiIPSpec:
    """Extract the stage structure from an (uncondensed) template.

    Verifies every structural assumption against the flat matrices rather
    than trusting the builder (same discipline as ``condense_template``).
    """
    t = template
    meta = t.row_meta
    assert meta is not None and t.S is None, \
        "ip_riccati needs an uncondensed template built by build_mpc_qp"
    assert not meta["terminal_eq_fallback"], \
        "tracking without a terminal set (x_N == xbar fallback) is not " \
        "supported by the Riccati IP; pass a terminal set"
    nx, nu, N = t.nx, t.nu, t.N
    nw = nx + nu if t.tracking else 0
    mt, mx, mu_, mN = meta["mt"], meta["mx"], meta["mu"], meta["mN"]
    nss = nx if meta["has_ss"] else 0
    fixed = meta["init_mode"] == "fixed"

    # ---- row slices in builder emission order -----------------------------
    r = 0
    sl_dyn = slice(r, r + N * nx); r += N * nx
    n_init = nx if fixed else mt
    sl_init = slice(r, r + n_init); r += n_init
    sl_ss = slice(r, r + nss); r += nss
    sl_x = slice(r, r + N * mx); r += N * mx
    sl_u = slice(r, r + N * mu_); r += N * mu_
    sl_N = slice(r, r + mN); r += mN
    assert r == t.m, f"row_meta layout mismatch: {r} != {t.m}"
    assert bool(t.is_eq[sl_dyn].all())
    if fixed:
        assert bool(t.is_eq[sl_init].all())
    else:
        assert not t.is_eq[sl_init].any()
    assert bool(t.is_eq[sl_ss].all())
    assert not t.is_eq[sl_x].any() and not t.is_eq[sl_u].any() \
        and not t.is_eq[sl_N].any()

    xs = t.x_slice
    us = t.u_slice
    A = -t.A[sl_dyn][:nx, xs(0)]
    B = -t.A[sl_dyn][:nx, us(0)]

    # ---- cost blocks ------------------------------------------------------
    Qx = t.P[xs(0), xs(0)]
    Ru = t.P[us(0), us(0)]
    QN = t.P[xs(N), xs(N)]
    if t.tracking:
        wsl = slice(t.xbar_slice.start, t.ubar_slice.stop)
        Cxw = t.P[xs(0), wsl]
        Cuw = t.P[us(0), wsl]
        CNw = t.P[xs(N), wsl]
        Hww = t.P[wsl, wsl]
        qw0 = t.q0[wsl]
        Mqw = t.Mq[wsl]
        Ass = t.A[sl_ss][:, wsl]
        assert np.allclose(t.A[sl_ss][:, :wsl.start], 0)
    else:
        Cxw = np.zeros((nx, 0)); Cuw = np.zeros((nu, 0))
        CNw = np.zeros((nx, 0)); Hww = np.zeros((0, 0))
        qw0 = np.zeros(0); Mqw = np.zeros((0, t.ntheta))
        Ass = np.zeros((0, 0))
    # verify stage blocks repeat and nothing else is in P/q
    for k in (1, N - 1):
        assert np.allclose(t.P[xs(k), xs(k)], Qx)
        assert np.allclose(t.P[us(k), us(k)], Ru)
        if t.tracking:
            assert np.allclose(t.P[xs(k), wsl], Cxw)
            assert np.allclose(t.P[us(k), wsl], Cuw)
    assert np.allclose(t.P[xs(0), xs(1)], 0)
    assert not t.q0[:xs(N).stop].any() and not t.Mq[:xs(N).stop].any()

    # ---- inequality groups ------------------------------------------------
    if mx:
        Hx = t.A[sl_x][:mx, xs(0)]
        hx = t.u0[sl_x][:mx]
        assert np.allclose(t.A[sl_x][mx:2 * mx, xs(1)], Hx)
        assert not t.Ml[sl_x].any() and not t.Mu[sl_x].any()
        assert not np.isfinite(t.l0[sl_x]).any()
    else:
        Hx = np.zeros((0, nx)); hx = np.zeros(0)
    if mu_:
        Hu = t.A[sl_u][:mu_, us(0)]
        hu = t.u0[sl_u][:mu_]
        assert not np.isfinite(t.l0[sl_u]).any()
    else:
        Hu = np.zeros((0, nu)); hu = np.zeros(0)
    if fixed:
        Ht = np.zeros((0, nx)); ht0 = np.zeros(0)
        Mht = np.zeros((0, t.ntheta))
        b00 = t.u0[sl_init].copy()
        Mb0 = t.Mu[sl_init].copy()
        assert np.allclose(t.A[sl_init][:, xs(0)], np.eye(nx))
    else:
        Ht = t.A[sl_init][:, xs(0)]
        ht0 = t.u0[sl_init].copy()
        Mht = t.Mu[sl_init].copy()
        b00 = np.zeros(nx); Mb0 = np.zeros((nx, t.ntheta))
        assert not np.isfinite(t.l0[sl_init]).any()
    if mN:
        GN = t.A[sl_N][:, xs(N)]
        GNw = t.A[sl_N][:, wsl] if t.tracking else np.zeros((mN, 0))
        hN = t.u0[sl_N].copy()
        assert not np.isfinite(t.l0[sl_N]).any()
        assert not t.Ml[sl_N].any() and not t.Mu[sl_N].any()
    else:
        GN = np.zeros((0, nx)); GNw = np.zeros((0, nw)); hN = np.zeros(0)

    # ---- scalings ---------------------------------------------------------
    # Three commuting equilibrations, all exact reformulations (the primal
    # returned to the caller is unscaled):
    # 1. scalar cost scaling c keeps f32 value-function magnitudes near
    #    unit scale;
    # 2. per-component variable scaling x = Sx x~, u = Su u~ (the SAME
    #    diagonal at every stage, so the dynamics keep their stage
    #    structure: A~ = Sx^-1 A Sx) — the structured analog of Ruiz
    #    column scaling, sized to whiten the quadratic cost diagonal;
    # 3. 2-norm row equilibration of every inequality row.
    c = 1.0 / max(1.0, np.abs(QN).max() if QN.size else 0.0,
                  np.abs(Qx).max(),
                  np.abs(Hww).max() if Hww.size else 0.0)
    Qx, Ru, QN = c * Qx, c * Ru, c * QN
    Cxw, Cuw, CNw, Hww = c * Cxw, c * Cuw, c * CNw, c * Hww
    qw0, Mqw = c * qw0, c * Mqw

    dQx = np.abs(np.diag(Qx))
    dQN = np.abs(np.diag(QN)) if QN.size else dQx
    sxv = 1.0 / np.sqrt(np.sqrt(np.maximum(dQx * np.maximum(dQN, dQx),
                                           1e-16)))
    suv = 1.0 / np.sqrt(np.maximum(np.abs(np.diag(Ru)), 1e-16))
    swv = np.concatenate([sxv, suv]) if nw else np.zeros(0)
    Sx, Su = np.diag(sxv), np.diag(suv)
    Sw = np.diag(swv) if nw else np.zeros((0, 0))
    Sxi = np.diag(1.0 / sxv)
    A = Sxi @ A @ Sx
    B = Sxi @ B @ Su
    Qx, Ru, QN = Sx @ Qx @ Sx, Su @ Ru @ Su, Sx @ QN @ Sx
    Cxw, Cuw, CNw = Sx @ Cxw @ Sw, Su @ Cuw @ Sw, Sx @ CNw @ Sw
    Hww = Sw @ Hww @ Sw
    qw0, Mqw = Sw @ qw0, Sw @ Mqw
    Ass = Ass @ Sw
    b00, Mb0 = Sxi @ b00, Sxi @ Mb0
    Hx, Hu, Ht = Hx @ Sx, Hu @ Su, Ht @ Sx
    GN, GNw = GN @ Sx, GNw @ Sw

    def rnorm(M, *Ms):
        full = np.hstack([M, *Ms]) if Ms else M
        nrm = np.linalg.norm(full, axis=1)
        return np.where(nrm > 0, nrm, 1.0)

    sx = rnorm(Hx) if mx else np.ones(0)
    su = rnorm(Hu) if mu_ else np.ones(0)
    st = rnorm(Ht) if mt else np.ones(0)
    sN = rnorm(GN, GNw) if mN else np.ones(0)
    sss = rnorm(Ass) if nss else np.ones(0)

    arr = lambda v: jnp.asarray(np.asarray(v, np.float64), dtype)
    div = lambda M, s_: M / s_[:, None] if M.shape[0] else M
    return RiccatiIPSpec(
        A=arr(A), B=arr(B),
        Qx=arr(Qx), Ru=arr(Ru), QN=arr(QN),
        Cxw=arr(Cxw), Cuw=arr(Cuw), CNw=arr(CNw),
        Hww=arr(Hww), qw0=arr(qw0), Mqw=arr(Mqw),
        Ass=arr(div(Ass, sss)), b00=arr(b00), Mb0=arr(Mb0),
        Hx=arr(div(Hx, sx)), hx=arr(hx / sx if mx else hx),
        Hu=arr(div(Hu, su)), hu=arr(hu / su if mu_ else hu),
        Ht=arr(div(Ht, st)), ht0=arr(ht0 / st if mt else ht0),
        Mht=arr(div(Mht, st)),
        GN=arr(div(GN, sN)), GNw=arr(div(GNw, sN)),
        hN=arr(hN / sN if mN else hN),
        c_obj=arr(c), Sx=arr(sxv), Su=arr(suv),
    )


# ---------------------------------------------------------------------------
# Riccati sweep: factor once per Newton system, solve many RHS columns
# ---------------------------------------------------------------------------

def _riccati_factor(spec, Qhat, Rhat, QhatN, reg):
    """Backward value recursion on the weighted stage blocks.

    Returns (V0, stacks) where stacks[k] = (V_{k+1}, K_k, F_k) for
    k = 0..N-1; the linear (RHS) sweeps reuse them.
    """
    A, B = spec.A, spec.B
    nx = A.shape[0]
    eye = jnp.eye(nx, dtype=A.dtype)

    def bwd(V, blocks):
        Qk, Rk = blocks
        BtV = _mm(B.T, V)
        F = Rk + _mm(BtV, B)
        G = _mm(BtV, A)
        K = _plu_solve(_plu_factor(F), G)
        Vn = Qk + _mm(A.T, _mm(V, A)) - _mm(G.T, K)
        Vn = 0.5 * (Vn + Vn.T) + reg * eye
        return Vn, (V, K, F)

    V0, stacks = jax.lax.scan(bwd, QhatN + reg * eye, (Qhat, Rhat),
                              reverse=True)
    return V0, stacks


def _riccati_solve(spec, V0, stacks, rx, ru, rd, rxN, dx0=None):
    """Solve the stage KKT for a batch of RHS columns (leading axis).

    In the Riccati convention the stage system is

        Qhat_k x_k - rx_k + [k>0] y_k - A' y_{k+1} = 0
        Rhat_k u_k - ru_k            - B' y_{k+1} = 0
        QhatN x_N - rxN + y_N                     = 0
        x_{k+1} = A x_k + B u_k + rd_k

    with x_0 = dx0 fixed (or free when ``dx0`` is None).

    rx: (nrhs, N, nx); ru: (nrhs, N, nu); rd: (nrhs, N, nx);
    rxN: (nrhs, nx).  Returns (xs, us, ys): xs (nrhs, N+1, nx),
    us (nrhs, N, nu), ys (nrhs, N, nx) = dynamics multipliers y_1..y_N.
    """
    A, B = spec.A, spec.B
    Vn, Ks, Fs = stacks

    def bwd(v, per_k):
        Vk1, Kk, Fk, rxk, ruk, rdk = per_k
        Vrd = _mm(rdk, Vk1.T)
        tB = _mm(Vrd + v, B)
        g = _plu_solve(_plu_factor(Fk), (tB - ruk).T).T
        vk = -rxk + _mm(v + Vrd, A) - _mm(tB - ruk, Kk)
        return vk, (g, vk)

    vN = -rxN
    v0, (gs, vs) = jax.lax.scan(
        bwd, vN, (Vn, Ks, Fs,
                  jnp.swapaxes(rx, 0, 1), jnp.swapaxes(ru, 0, 1),
                  jnp.swapaxes(rd, 0, 1)),
        reverse=True)
    if dx0 is None:
        dx0 = -_plu_solve(_plu_factor(V0), v0.T).T

    def fwd(x, per_k):
        Kk, gk, rdk = per_k
        u = -_mm(x, Kk.T) - gk
        xn = _mm(x, A.T) + _mm(u, B.T) + rdk
        return xn, (x, u)

    xN, (xs_, us_) = jax.lax.scan(
        fwd, dx0, (Ks, gs, jnp.swapaxes(rd, 0, 1)))
    xs_ = jnp.concatenate([jnp.swapaxes(xs_, 0, 1), xN[:, None]], axis=1)
    us_ = jnp.swapaxes(us_, 0, 1)
    # costates: y_k = -(V_k x_k + v_k), k = 1..N
    vk_stack = jnp.concatenate(
        [jnp.swapaxes(vs, 0, 1)[:, 1:], vN[:, None]], axis=1)
    ys = -(_es('kij,rkj->rki', Vn, xs_[:, 1:]) + vk_stack)
    return xs_, us_, ys


def ip_riccati_solve(spec: RiccatiIPSpec, theta: jax.Array, N: int,
                     iters: int = 25, state0=None, want_state: bool = False,
                     warm: str = "resume"):
    """Mehrotra predictor-corrector with the Riccati/arrowhead KKT solve.

    Single instance; ``vmap`` over ``theta`` for batches.  ``N`` is the
    (static) horizon.  Returns the primal in the full template layout
    [x_0..x_N | u_0..u_{N-1} | xbar ubar] like ``ops/ip.py:ip_solve``
    (residuals in the scaled metric, same convention).

    ``state0``: optional warm interior state (the tuple returned with
    ``want_state=True``, any float dtype — cast in); used by the hybrid
    precision driver and by closed-loop warm starts.
    """
    dt = spec.A.dtype
    theta = theta.astype(dt)
    nx, nu = spec.B.shape
    nw = spec.Hww.shape[0]
    nss = spec.Ass.shape[0]
    mx, mu_, mt, mN = (spec.Hx.shape[0], spec.Hu.shape[0],
                       spec.Ht.shape[0], spec.GN.shape[0])
    fixed = mt == 0
    m_total = max(N * mx + N * mu_ + mt + mN, 1)
    eps = jnp.asarray(jnp.finfo(dt).eps, dt)
    reg = 10.0 * eps

    qw = spec.qw0 + _mm(spec.Mqw, theta)
    b0 = spec.b00 + _mm(spec.Mb0, theta)
    ht = spec.ht0 + _mm(spec.Mht, theta)
    hx_b = jnp.broadcast_to(spec.hx, (N, mx))
    hu_b = jnp.broadcast_to(spec.hu, (N, mu_))

    def ineq_products(x, u, w):
        """A_i z per row group: ((N,mx), (N,mu), (mt,), (mN,))."""
        ax = _es('ri,ki->kr', spec.Hx, x[:N])
        au = _es('ri,ki->kr', spec.Hu, u)
        at = _mm(spec.Ht, x[0])
        aN = _mm(spec.GN, x[N]) + _mm(spec.GNw, w)
        return ax, au, at, aN

    def gsum(groups):
        return sum(jnp.sum(g) for g in groups)

    # ------------------------------------------------------------------
    def build_factor(lam, s):
        """Weighted stage blocks + Riccati factorization + w-Schur."""
        Dx = lam[0] / s[0]
        Du = lam[1] / s[1]
        Dt = lam[2] / s[2]
        DN = lam[3] / s[3]
        Qhat = spec.Qx[None] + _es('ri,kr,rj->kij', spec.Hx, Dx, spec.Hx)
        Qhat = Qhat.at[0].add(_es('ri,r,rj->ij', spec.Ht, Dt, spec.Ht))
        Rhat = spec.Ru[None] + _es('ri,kr,rj->kij', spec.Hu, Du, spec.Hu)
        QhatN = spec.QN + _es('ri,r,rj->ij', spec.GN, DN, spec.GN)
        CNd = spec.CNw + _es('ri,r,rj->ij', spec.GN, DN, spec.GNw)
        Hwwd = spec.Hww + _es('ri,r,rj->ij', spec.GNw, DN, spec.GNw)
        return finish_factor(Qhat, Rhat, QhatN, CNd, Hwwd) \
            + ((Dx, Du, Dt, DN),)

    def finish_factor(Qhat, Rhat, QhatN, CNd, Hwwd):
        fact = _riccati_factor(spec, Qhat, Rhat, QhatN, reg)
        if nw:
            # sensitivity columns: stage solves with rx = -C e_j
            rx_s = -jnp.broadcast_to(spec.Cxw.T[:, None, :], (nw, N, nx))
            ru_s = -jnp.broadcast_to(spec.Cuw.T[:, None, :], (nw, N, nu))
            rd_s = jnp.zeros((nw, N, nx), dt)
            rxN_s = -CNd.T
            dx0_s = jnp.zeros((nw, nx), dt) if fixed else None
            xs_s, us_s, ys_s = _riccati_solve(
                spec, fact[0], fact[1], rx_s, ru_s, rd_s, rxN_s,
                dx0=dx0_s)
            # C' Z:  [w, j] = sum_k Cxw' dx_k^j + Cuw' du_k^j + CNd' dx_N^j
            CtZ = (_es('iw,jki->wj', spec.Cxw, xs_s[:, :N])
                   + _es('iw,jki->wj', spec.Cuw, us_s)
                   + _es('iw,ji->wj', CNd, xs_s[:, N]))
            # w-Schur saddle [[M11, Ass'], [Ass, -reg]], pivoted-LU
            # factored (M11 = the QP's reduced Hessian on w is PSD in
            # exact arithmetic but can round indefinite in its soft
            # modes; pivoting keeps the solve faithful where a clamped
            # Cholesky silently flips signs)
            M11 = Hwwd + 0.5 * (CtZ + CtZ.T)
            M = jnp.zeros((nw + nss, nw + nss), dt)
            M = M.at[:nw, :nw].set(M11)
            M = M.at[:nw, nw:].set(spec.Ass.T)
            M = M.at[nw:, :nw].set(spec.Ass)
            M = M.at[nw:, nw:].set(-reg * jnp.eye(nss, dtype=dt))
            M_fac = _plu_factor(M)
            sens = (xs_s, us_s, ys_s)
        else:
            M_fac = None
            sens = None
        return fact, M_fac, sens, CNd

    def solve_kkt_once(factpack, rx_eff, ru_eff, rxN_eff, rw_eff,
                       rd_eff, rss_eff, dx0):
        """Raw arrowhead solve for one RHS (no refinement)."""
        fact, M_fac, sens, CNd = factpack
        xsb, usb, ysb = _riccati_solve(
            spec, fact[0], fact[1], rx_eff[None], ru_eff[None],
            rd_eff[None], rxN_eff[None],
            dx0=None if dx0 is None else dx0[None])
        if nw:
            Cz = (_es('iw,ki->w', spec.Cxw, xsb[0, :N])
                  + _es('iw,ki->w', spec.Cuw, usb[0])
                  + _es('iw,i->w', CNd, xsb[0, N]))
            sol = _plu_solve(M_fac, jnp.concatenate([rw_eff - Cz,
                                                     rss_eff]))
            dw, dmu = sol[:nw], sol[nw:]
            xs_s, us_s, ys_s = sens
            dx = xsb[0] + _es('jki,j->ki', xs_s, dw)
            du = usb[0] + _es('jki,j->ki', us_s, dw)
            dy = ysb[0] + _es('jki,j->ki', ys_s, dw)
        else:
            dw = jnp.zeros(0, dt); dmu = jnp.zeros(0, dt)
            dx, du, dy = xsb[0], usb[0], ysb[0]
        return dx, du, dw, dmu, dy

    def apply_kkt(D, CNd_unused, dx, du, dw, dmu, dy):
        """Exact Newton-operator application (weights applied row-wise,
        never forming the fused blocks — more accurate than the
        factorization path, which is what refinement needs)."""
        Dx, Du, Dt, DN = D
        aNd = _mm(spec.GN, dx[N]) + _mm(spec.GNw, dw)
        ox = (_es('ij,kj->ki', spec.Qx, dx[:N]) + _mm(spec.Cxw, dw)[None]
              + _es('ri,kr->ki', spec.Hx,
                    Dx * _es('ri,ki->kr', spec.Hx, dx[:N]))
              - _es('ji,kj->ki', spec.A, dy))
        ox = ox.at[0].add(_mm(spec.Ht.T, Dt * _mm(spec.Ht, dx[0])))
        ox = ox.at[1:].add(dy[:N - 1])
        ou = (_es('ij,kj->ki', spec.Ru, du) + _mm(spec.Cuw, dw)[None]
              + _es('ri,kr->ki', spec.Hu,
                    Du * _es('ri,ki->kr', spec.Hu, du))
              - _es('ji,kj->ki', spec.B, dy))
        oxN = (_mm(spec.QN, dx[N]) + _mm(spec.CNw, dw)
               + _mm(spec.GN.T, DN * aNd) + dy[N - 1])
        ow = (_es('ki,iw->w', dx[:N], spec.Cxw)
              + _es('ki,iw->w', du, spec.Cuw)
              + _mm(spec.CNw.T, dx[N]) + _mm(spec.Hww, dw)
              + _mm(spec.GNw.T, DN * aNd) + _mm(spec.Ass.T, dmu))
        od = dx[1:] - _es('ij,kj->ki', spec.A, dx[:N]) \
            - _es('ij,kj->ki', spec.B, du)
        oss = _mm(spec.Ass, dw)
        return ox, ou, oxN, ow, od, oss

    # Iterative refinement is an f32 need: the f32 Riccati sweep loses
    # ~3 digits over the N-stage recursion on stiff barriers, and one
    # residual re-solve restores direction accuracy (measured).  In f64
    # with a FIXED initial state the pivoted-LU sweeps are accurate
    # enough alone — skipping the re-solve HALVES the (emulated,
    # ~50x-cost) f64 per-iteration price with no measured accuracy
    # change.  Free-initial-state (tube-init) solves keep it: without IR
    # their endgame stalls ~5e-5 short (measured on the Mayne geometry).
    default_refine = 0 if (dt == jnp.float64 and fixed) else 1

    def solve_newton(factpack, tx, tu, tt, tN,
                     rdx, rdu, rdxN, rdw, re_d, re_ss, refine=None):
        """One Newton solve with ``refine`` rounds of iterative
        refinement (the f32 Riccati sweep alone loses ~3 digits over the
        N-stage recursion on stiff barriers; one residual re-solve
        restores direction accuracy to f32 roundoff — measured).

        t* = eliminated-inequality terms per group; rd* = stationarity
        residuals; re_* = equality residuals; the fixed initial state
        enters as dx0 = -re_0 (``re_0_cur``).  Returns directions
        (dx (N+1,nx), du (N,nu), dw, dmu, dy (N,nx))."""
        if refine is None:
            refine = default_refine
        D = factpack[4]
        rx_eff = -(rdx + _es('ri,kr->ki', spec.Hx, tx))
        rx_eff = rx_eff.at[0].add(-_mm(spec.Ht.T, tt))
        ru_eff = -(rdu + _es('ri,kr->ki', spec.Hu, tu))
        rxN_eff = -(rdxN + _mm(spec.GN.T, tN))
        rw_eff = -(rdw + _mm(spec.GNw.T, tN))
        rd_eff = -re_d
        rss_eff = -re_ss
        dx0 = (-re_0_cur[0]) if fixed else None
        d = solve_kkt_once(factpack[:4], rx_eff, ru_eff, rxN_eff,
                           rw_eff, rd_eff, rss_eff, dx0)
        for _ in range(refine):
            ox, ou, oxN, ow, od, oss = apply_kkt(D, None, *d)
            # KKT convention: stage rows read  op = rx_eff (etc.)
            ex = rx_eff - ox
            if fixed:
                ex = ex.at[0].set(0.0)
            e = solve_kkt_once(
                factpack[:4], ex, ru_eff - ou, rxN_eff - oxN,
                rw_eff - ow, rd_eff - od, rss_eff - oss,
                jnp.zeros(nx, dt) if fixed else None)
            d = tuple(a + b for a, b in zip(d, e))
        return d

    # current fixed-init equality residual, rebound per call site (kept
    # out of solve_newton's signature to keep the two modes uniform)
    re_0_cur = [jnp.zeros(nx, dt)]

    def residuals(x, u, w, y, mu_ss, lam, s):
        """Stationarity/equality/inequality residuals.

        Stage-0 stationarity is omitted in fixed-init mode (its multiplier
        is implicit: the equality pins x_0, so the multiplier absorbs the
        gradient exactly — same convention Clarabel reports)."""
        ax, au, at, aN = ineq_products(x, u, w)
        rdx = (_es('ij,kj->ki', spec.Qx, x[:N]) + _mm(spec.Cxw, w)[None]
               + _es('ri,kr->ki', spec.Hx, lam[0]))
        rdx = rdx.at[0].add(_mm(spec.Ht.T, lam[2]))
        rdx = rdx - _es('ji,kj->ki', spec.A, y)
        rdx = rdx.at[1:].add(y[:N - 1])
        if fixed:
            rdx = rdx.at[0].set(0.0)
        rdu = (_es('ij,kj->ki', spec.Ru, u) + _mm(spec.Cuw, w)[None]
               + _es('ri,kr->ki', spec.Hu, lam[1])
               - _es('ji,kj->ki', spec.B, y))
        rdxN = (_mm(spec.QN, x[N]) + _mm(spec.CNw, w)
                + _mm(spec.GN.T, lam[3]) + y[N - 1])
        rdw = (_es('ki,iw->w', x[:N], spec.Cxw)
               + _es('ki,iw->w', u, spec.Cuw)
               + _mm(spec.CNw.T, x[N]) + _mm(spec.Hww, w) + qw
               + _mm(spec.GNw.T, lam[3]) + _mm(spec.Ass.T, mu_ss))
        re_d = x[1:] - _es('ij,kj->ki', spec.A, x[:N]) \
            - _es('ij,kj->ki', spec.B, u)
        re_0 = (x[0] - b0) if fixed else jnp.zeros(nx, dt)
        re_ss = _mm(spec.Ass, w)
        ri = (ax + s[0] - hx_b, au + s[1] - hu_b, at + s[2] - ht,
              aN + s[3] - spec.hN)
        return rdx, rdu, rdxN, rdw, re_d, re_0, re_ss, ri

    if state0 is None:
        # ----- initial point: equality-feasible regularized minimizer ------
        eye_x = jnp.eye(nx, dtype=dt)
        eye_u = jnp.eye(nu, dtype=dt)
        Qh0 = jnp.broadcast_to(spec.Qx + eye_x, (N, nx, nx))
        Rh0 = jnp.broadcast_to(spec.Ru + eye_u, (N, nu, nu))
        zg = (jnp.zeros((N, mx), dt), jnp.zeros((N, mu_), dt),
              jnp.zeros(mt, dt), jnp.zeros(mN, dt))
        pack0 = finish_factor(Qh0, Rh0, spec.QN + eye_x, spec.CNw,
                              spec.Hww + jnp.eye(nw, dtype=dt)) + (zg,)
        re_0_cur[0] = -b0            # dx0 = b0 from the zero start
        # refine=0: the start system is deliberately regularized (cost+I),
        # so refining toward the unregularized operator would be wrong
        x, u, w, _, _ = solve_newton(
            pack0, *zg,
            jnp.zeros((N, nx), dt), jnp.zeros((N, nu), dt),
            jnp.zeros(nx, dt), qw,
            jnp.zeros((N, nx), dt), jnp.zeros(nss, dt), refine=0)
        ax, au, at, aN = ineq_products(x, u, w)
        s_init = lambda a, h: jnp.maximum(h - a, 1.0)
        s = (s_init(ax, hx_b), s_init(au, hu_b), s_init(at, ht),
             s_init(aN, spec.hN))
        lam = (jnp.ones((N, mx), dt), jnp.ones((N, mu_), dt),
               jnp.ones(mt, dt), jnp.ones(mN, dt))
        y = jnp.zeros((N, nx), dt)
        mu_ss = jnp.zeros(nss, dt)
    elif warm == "resume":
        # Same-problem continuation (the hybrid's f32 -> f64 handoff):
        # the state is already centered for THIS theta — keep it, only
        # floor away exact zeros from the lower-precision phase.
        floor = jnp.asarray(1e-12 if dt == jnp.float64 else 1e-7, dt)
        x, u, w, y, mu_ss, lam, s = jax.tree_util.tree_map(
            lambda a: a.astype(dt), state0)
        lam = tuple(jnp.maximum(lg, floor) for lg in lam)
        s = tuple(jnp.maximum(sg, floor) for sg in s)
    else:
        # "shifted": warm start across a CHANGED problem.  Keep the
        # primal/dual iterate, but rebuild the slacks from the new
        # parameters and re-center the duals — carrying converged slacks
        # verbatim pins the first step lengths at ~0 for the new problem
        # (stale active set) and stalls the solve (measured).  NOTE:
        # still measurably less robust than a cold start on transients;
        # the rollout engine deliberately solves cold per step.
        assert warm == "shifted", warm
        floor = jnp.asarray(1e-4, dt)
        x, u, w, y, mu_ss, lam, s_old = jax.tree_util.tree_map(
            lambda a: a.astype(dt), state0)
        ax0, au0, at0, aN0 = ineq_products(x, u, w)
        s = (jnp.maximum(hx_b - ax0, floor),
             jnp.maximum(hu_b - au0, floor),
             jnp.maximum(ht - at0, floor),
             jnp.maximum(spec.hN - aN0, floor))
        lam = tuple(jnp.clip(lg, floor, 1.0 / floor) for lg in lam)

    def max_step(groups, dgroups):
        a = jnp.asarray(1.0, dt)
        for v, dv in zip(groups, dgroups):
            v = v.reshape(-1); dv = dv.reshape(-1)
            neg = dv < 0
            ratios = jnp.where(neg, -v / jnp.where(neg, dv, -1.0), 1.0)
            a = jnp.minimum(a, jnp.min(ratios, initial=1.0))
        return a

    # freeze floor: the barrier can be driven ~1e-23 before lam/s ratios
    # poison the Riccati blocks (measured on the extended-MPC template),
    # but there is nothing there — Clarabel's own bar is a 1e-7 gap
    # (``TrackingMPC.py:129``); stop comfortably above the blow-up with
    # residuals at ~1e-14.  f32's usable floor is ~1e-6 (as ops/ip.py).
    # stop_r: residual bar that must ALSO be met before freezing.
    if dt == jnp.float64:
        stop_mu = jnp.asarray(1e-18, dt)
        stop_r = jnp.asarray(1e-11, dt)
    else:
        stop_mu = jnp.asarray(1e-6, dt)
        stop_r = jnp.asarray(1e-4, dt)

    def body(st):
        i, _, cur, best_score, best = st
        x, u, w, y, mu_ss, lam, s = cur
        rdx, rdu, rdxN, rdw, re_d, re_0, re_ss, ri = residuals(
            x, u, w, y, mu_ss, lam, s)
        re_0_cur[0] = re_0
        mu = gsum(lg * sg for lg, sg in zip(lam, s)) / m_total
        rnorm = jnp.max(jnp.concatenate([
            jnp.abs(rdx).reshape(-1), jnp.abs(rdu).reshape(-1),
            jnp.abs(rdxN), jnp.abs(rdw), jnp.abs(re_d).reshape(-1),
            jnp.abs(re_0), jnp.abs(re_ss)]), initial=0.0)
        # best-iterate tracking: Mehrotra can blow up AFTER passing
        # through an excellent point on hard transients (measured: rd
        # 1e-9 mid-path, 1e50 at exit); the solve returns the best point
        # visited, which makes such blow-ups harmless.
        score = rnorm + mu
        better = jnp.logical_and(score < best_score,
                                 jnp.isfinite(score))
        best_score = jnp.where(better, score, best_score)
        best = jax.tree_util.tree_map(
            lambda new, old: jnp.where(better, new, old), cur, best)
        pack = build_factor(lam, s)

        def directions(rcs):
            ts = tuple((-rc + lg * rg) / sg
                       for rc, lg, rg, sg in zip(rcs, lam, ri, s))
            dx, du, dw, dmu, dy = solve_newton(
                pack, *ts, rdx, rdu, rdxN, rdw, re_d, re_ss)
            dax = _es('ri,ki->kr', spec.Hx, dx[:N])
            dau = _es('ri,ki->kr', spec.Hu, du)
            dat = _mm(spec.Ht, dx[0])
            daN = _mm(spec.GN, dx[N]) + _mm(spec.GNw, dw)
            das = (dax, dau, dat, daN)
            ds = tuple(-rg - da for rg, da in zip(ri, das))
            dlam = tuple((-rc - lg * dsg) / sg
                         for rc, lg, dsg, sg in zip(rcs, lam, ds, s))
            return dx, du, dw, dmu, dy, ds, dlam

        # predictor
        rcs_aff = tuple(lg * sg for lg, sg in zip(lam, s))
        dx_a, du_a, dw_a, dmu_a, dy_a, ds_a, dlam_a = directions(rcs_aff)
        ap = max_step(s, ds_a)
        ad = max_step(lam, dlam_a)
        mu_aff = gsum((lg + ad * dlg) * (sg + ap * dsg)
                      for lg, dlg, sg, dsg
                      in zip(lam, dlam_a, s, ds_a)) / m_total
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, eps)) ** 3, 0.0, 1.0)
        # (A residual-driven centering override was tried here and
        # REMOVED: forcing sigma ~ 0.95 while residuals lag deadlocks
        # Mehrotra on hard bang-bang transients — measured.  Premature
        # freezing is instead prevented by the freeze below requiring
        # BOTH the barrier and the residuals to be converged.)

        # corrector
        rcs = tuple(lg * sg + dlg * dsg - sigma * mu
                    for lg, sg, dlg, dsg in zip(lam, s, dlam_a, ds_a))
        dx, du, dw, dmu, dy, ds, dlam = directions(rcs)
        ap = jnp.minimum(1.0, 0.99 * max_step(s, ds))
        ad = jnp.minimum(1.0, 0.99 * max_step(lam, dlam))

        # freeze once converged (prevents post-convergence blow-up under
        # the fixed iteration count — same rule as ops/ip.py), where
        # "converged" means BOTH the barrier and the KKT residuals are
        # down (the mu-only rule froze at non-converged points on hard
        # active sets); a hard barrier floor still stops the iteration
        # when residuals sit at the dtype's noise floor.  Where-select
        # rather than zero-step so a NaN direction cannot poison the
        # frozen state.
        done = jnp.logical_and(mu < stop_mu, rnorm < stop_r)
        go = jnp.logical_and(~done, jnp.isfinite(mu))
        go = jnp.logical_and(go, mu > 0.01 * stop_mu)
        # a non-finite direction must neither be applied nor re-attempted
        # (the factorization at this state is broken — stop here)
        step_ok = jnp.isfinite(
            ap + ad + jnp.sum(dx) + jnp.sum(du) + jnp.sum(dw)
            + jnp.sum(dy) + sum(jnp.sum(g) for g in ds)
            + sum(jnp.sum(g) for g in dlam))
        go = jnp.logical_and(go, step_ok)
        pick = lambda new, old: jnp.where(go, new, old)
        # per-row floor: the freeze watches AGGREGATE mu, so an individual
        # slack can underflow to exactly 0 mid-solve (measured in f32 on
        # warm-started transients) -> lam/s = inf -> NaN factorization.
        # tiny keeps D = lam/s finite without affecting converged rows.
        tiny = jnp.asarray(1e-25 if dt == jnp.float64 else 1e-10, dt)
        cur_new = (
            pick(x + ap * dx, x), pick(u + ap * du, u),
            pick(w + ap * dw, w), pick(y + ad * dy, y),
            pick(mu_ss + ad * dmu, mu_ss),
            tuple(pick(jnp.maximum(lg + ad * dlg, tiny), lg)
                  for lg, dlg in zip(lam, dlam)),
            tuple(pick(jnp.maximum(sg + ap * dsg, tiny), sg)
                  for sg, dsg in zip(s, ds)))
        return (i + 1, go, cur_new, best_score, best)

    # while (not converged) — under vmap the loop runs until every batch
    # lane's flag clears, so easy/warm-started batches pay only the
    # iterations the HARDEST lane needs, not the fixed budget (a frozen
    # lane's body is a no-op via the pick-selects above)
    cur0 = (x, u, w, y, mu_ss, lam, s)
    st0 = (jnp.zeros((), jnp.int32), jnp.ones((), bool), cur0,
           jnp.asarray(jnp.finfo(dt).max, dt), cur0)
    _, _, cur, best_score, best = jax.lax.while_loop(
        lambda st: jnp.logical_and(st[0] < iters, st[1]), body, st0)
    # final point: the best iterate visited, unless the last iterate both
    # improved on it (its residuals were never scored) — just score-check
    # by recomputing on the current iterate too
    x, u, w, y, mu_ss, lam, s = best
    rdx_c, rdu_c, rdxN_c, rdw_c, re_d_c, re_0_c, re_ss_c, _ = residuals(
        *cur)
    mu_c = gsum(lg * sg for lg, sg in zip(cur[5], cur[6])) / m_total
    score_c = jnp.max(jnp.concatenate([
        jnp.abs(rdx_c).reshape(-1), jnp.abs(rdu_c).reshape(-1),
        jnp.abs(rdxN_c), jnp.abs(rdw_c), jnp.abs(re_d_c).reshape(-1),
        jnp.abs(re_0_c), jnp.abs(re_ss_c)]), initial=0.0) + mu_c
    take_cur = jnp.logical_and(score_c < best_score,
                               jnp.isfinite(score_c))
    x, u, w, y, mu_ss, lam, s = jax.tree_util.tree_map(
        lambda c, b: jnp.where(take_cur, c, b), cur, best)

    # ----- final residuals (scaled metric, as ops/ip.py) -------------------
    ax, au, at, aN = ineq_products(x, u, w)
    viol = lambda a, h: jnp.max(jnp.maximum(a - h, 0.0), initial=0.0)
    r_prim = jnp.maximum(
        jnp.max(jnp.abs(x[1:] - _es('ij,kj->ki', spec.A, x[:N])
                        - _es('ij,kj->ki', spec.B, u)), initial=0.0),
        jnp.maximum(
            jnp.maximum(viol(ax, hx_b), viol(au, hu_b)),
            jnp.maximum(viol(at, ht), viol(aN, spec.hN))))
    if fixed:
        r_prim = jnp.maximum(r_prim, jnp.max(jnp.abs(x[0] - b0)))
    if nss:
        r_prim = jnp.maximum(r_prim, jnp.max(jnp.abs(_mm(spec.Ass, w))))
    rdx, rdu, rdxN, rdw, *_ = residuals(x, u, w, y, mu_ss, lam, s)
    r_dual = jnp.max(jnp.concatenate([
        jnp.abs(rdx).reshape(-1), jnp.abs(rdu).reshape(-1),
        jnp.abs(rdxN), jnp.abs(rdw)]), initial=0.0)
    gap = gsum(lg * sg for lg, sg in zip(lam, s)) / m_total

    # unscale the primal back to template units (x = Sx x~, etc.)
    sw = jnp.concatenate([spec.Sx, spec.Su])[:nw]
    z = jnp.concatenate([(x * spec.Sx).reshape(-1),
                         (u * spec.Su).reshape(-1), w * sw])
    sol = IPSolution(z_primal=z, r_prim=r_prim, r_dual=r_dual, gap=gap)
    if want_state:
        return sol, (x, u, w, y, mu_ss, lam, s)
    return sol


def init_ip_state(spec: RiccatiIPSpec, N: int, dtype=None):
    """Neutral interior state (x = 0, s = lam = 1) for cold starts and as
    the closed-loop warm-start carry's initial value."""
    dt = dtype if dtype is not None else spec.A.dtype
    nx, nu = spec.B.shape
    nw = spec.Hww.shape[0]
    nss = spec.Ass.shape[0]
    mx, mu_, mt, mN = (spec.Hx.shape[0], spec.Hu.shape[0],
                       spec.Ht.shape[0], spec.GN.shape[0])
    return (jnp.zeros((N + 1, nx), dt), jnp.zeros((N, nu), dt),
            jnp.zeros(nw, dt), jnp.zeros((N, nx), dt),
            jnp.zeros(nss, dt),
            (jnp.ones((N, mx), dt), jnp.ones((N, mu_), dt),
             jnp.ones(mt, dt), jnp.ones(mN, dt)),
            (jnp.ones((N, mx), dt), jnp.ones((N, mu_), dt),
             jnp.ones(mt, dt), jnp.ones(mN, dt)))


def ip_riccati_solve_hybrid(spec: RiccatiIPSpec, theta: jax.Array, N: int,
                            iters32: int = 25, iters64: int = 8,
                            state0=None, want_state: bool = False):
    """Mixed-precision accuracy mode: f32 path-following, f64 polish.

    The f32 solve lands within ~1e-3..1 of the optimum in a handful of
    hard cases only because its residual arithmetic floors at ~1e-6;
    warm-starting a SHORT f64 Mehrotra phase from the f32 interior point
    buys back exact reference-grade accuracy for a fraction of the
    full-f64 cost.  (The 25+12 split was tuned for a chip that emulates
    f64; on a card with native f64 it is an open question, ROADMAP A.)  ``spec`` must be the f64 spec; phase 1 runs on a cast-down
    copy (identical scalings, so the interior state transfers directly).
    """
    assert spec.A.dtype == jnp.float64, "hybrid needs the f64 spec"
    spec32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), spec)
    _, st = ip_riccati_solve(spec32, theta.astype(jnp.float32), N,
                             iters=iters32, state0=state0, warm="shifted",
                             want_state=True)
    return ip_riccati_solve(spec, theta.astype(jnp.float64), N,
                            iters=iters64, state0=st, warm="resume",
                            want_state=want_state)
