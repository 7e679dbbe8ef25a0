"""Fused batched ADMM QP solve as a Pallas kernel for NVIDIA GPUs (Triton).

``admm_solve`` (``qp.py``) expresses one OSQP-style iteration in jnp and is
vmapped over the batch; under XLA every iteration is a handful of separate
GEMM and elementwise kernels whose intermediates round-trip through device
memory.  This kernel runs the WHOLE fixed iteration budget inside one block
per batch tile: the per-instance iterates ``(x, y, z)`` stay in registers
from the first iteration to the last, and the loop issues no launches.

Layout, chosen for the card:

* one block per tile of ``block_b`` instances (a power of two, >= 16);
* the iteration budget is an in-block ``lax.fori_loop``;
* the composite iteration matrices (``prepare_admm``: ``Gxc``/``Gsc``) are
  split into their four ``[xt | zt]`` blocks, zero-padded to powers of two
  and loaded once per block before the loop;
* the per-solve maps ``q/l/u`` and ``q @ Kcat`` (contraction width
  ``ntheta``, below the kernel dot's minimum of 16) run in plain XLA before
  the call, and the KKT residuals after it;
* ``alpha`` is a one-element operand.

Matmul precision follows ``ops/precision.py``: "highest" runs IEEE f32
dots (no TF32); "high" runs the 3-pass bf16 product (hi*hi + hi*lo +
lo*hi) with the loop-invariant matrices split once, outside the kernel.

Replaces: per-step CVXPY/Clarabel solves of the reference
(``TubeTrackingMPC.py:183``, ``RegulatorMPC.py:31``).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import precision as _prec
from .qp import ADMMSpec, ADMMState, ADMMSolution

__all__ = ["admm_solve_pallas", "pow2_width"]

_DIMS = (((1,), (0,)), ((), ()))
_MIN_WIDTH = 16          # smallest operand width the Triton dot accepts


def pow2_width(v: int) -> int:
    """Smallest power of two >= ``max(v, 16)``: the kernel's padded width."""
    p = _MIN_WIDTH
    while p < v:
        p *= 2
    return p


def _split_bf16(a):
    """bf16 (high, residual) decomposition of an f32 array."""
    a32 = a.astype(jnp.float32)
    ahi = a32.astype(jnp.bfloat16)
    alo = (a32 - ahi.astype(jnp.float32)).astype(jnp.bfloat16)
    return ahi, alo


def _dot(a, b, out_dtype):
    return jax.lax.dot_general(a, b, dimension_numbers=_DIMS,
                               precision=jax.lax.Precision.HIGHEST,
                               preferred_element_type=out_dtype)


def _dot3(a_split, b_split):
    """3-pass bf16 product of pre-split operand pairs."""
    ahi, alo = a_split
    bhi, blo = b_split

    def d(u, v):
        return jax.lax.dot_general(u, v, dimension_numbers=_DIMS,
                                   preferred_element_type=jnp.float32)

    return d(ahi, blo) + d(alo, bhi) + d(ahi, bhi)


def _admm_kernel(alpha_ref, x_ref, y_ref, z_ref, qx_ref, qz_ref, l_ref,
                 u_ref, rho_ref, rhoinv_ref, *refs, iters: int, split: bool):
    n_mat = 8 if split else 4
    mat_refs, (x_out, y_out, z_out) = refs[:n_mat], refs[n_mat:]
    dt = x_ref.dtype
    alpha = alpha_ref[0]
    rho = rho_ref[...]                  # (1, m2) broadcasts over the tile
    rho_inv = rhoinv_ref[...]
    # composites, loaded once per block: x->xt, s->xt, x->zt, s->zt
    mats = [r[...] for r in mat_refs]
    if split:
        mats = [(mats[2 * i], mats[2 * i + 1]) for i in range(4)]
        prep = _split_bf16
        dot = _dot3
    else:
        prep = lambda a: a
        dot = functools.partial(_dot, out_dtype=dt)
    Gxx, Gsx, Gxz, Gsz = mats

    def body(_, st):
        x, y, z = st
        s = rho * z - y
        xs, ss = prep(x), prep(s)
        xt = dot(xs, Gxx) + dot(ss, Gsx) - qx_ref[...]
        zt = dot(xs, Gxz) + dot(ss, Gsz) - qz_ref[...]
        x_new = alpha * xt + (1.0 - alpha) * x
        z_mix = alpha * zt + (1.0 - alpha) * z
        z_new = jnp.minimum(jnp.maximum(z_mix + y * rho_inv, l_ref[...]),
                            u_ref[...])
        y_new = y + rho * (z_mix - z_new)
        return x_new, y_new, z_new

    x, y, z = jax.lax.fori_loop(0, iters, body,
                                (x_ref[...], y_ref[...], z_ref[...]))
    x_out[...] = x
    y_out[...] = y
    z_out[...] = z


def admm_solve_pallas(spec: ADMMSpec, theta: jax.Array,
                      state: Optional[ADMMState] = None,
                      iters: int = 100,
                      block_b: int = 16,
                      num_warps: int = 8,
                      interpret: bool = False) -> ADMMSolution:
    """Batch-explicit fused solve: ``theta`` is ``(B, ntheta)``, the state
    leaves are ``(B, n_p)`` / ``(B, m_p)``.  Returns a batched
    ``ADMMSolution`` (``z_primal`` ``(B, n_p)``, residuals ``(B,)``).

    The same iteration as ``qp.admm_solve`` (same warm-start semantics,
    composite matrices formed in f64 by ``prepare_admm``); parity is
    asserted in ``tests/test_qp_pallas.py`` in interpret mode and, compiled
    for the card, by ``tools/parity_checks.py``.  ``block_b=16`` with
    ``num_warps=8`` won a tile x warps sweep on an H100 at the flagship
    widths (``tools/bench_pallas_kernel.py``); larger tiles ran slower.
    """
    B, _ = theta.shape
    n_p = spec.Kinv.shape[0]
    m_p = spec.As.shape[0]
    dt = spec.Kinv.dtype
    theta = theta.astype(dt)
    if state is None:
        state = ADMMState(x=jnp.zeros((B, n_p), dt),
                          y=jnp.zeros((B, m_p), dt),
                          z=jnp.zeros((B, m_p), dt))
    mm = _prec.mm
    # per-solve parameter maps in XLA (contraction width ntheta)
    q = spec.q0[None, :] + mm(theta, spec.Mq.T)            # (B, n_p)
    l = spec.l0[None, :] + mm(theta, spec.Ml.T)            # (B, m_p)
    u = spec.u0[None, :] + mm(theta, spec.Mu.T)
    qcat = mm(q, spec.Kcat)                                # (B, n_p + m_p)

    n2, m2 = pow2_width(n_p), pow2_width(m_p)
    bt = pow2_width(block_b)
    B_pad = -(-B // bt) * bt

    def pad(a, cols):
        return jnp.pad(a, ((0, B_pad - a.shape[0]), (0, cols - a.shape[1])))

    def padm(a, rows, cols):
        return jnp.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])))

    def padrow(v, fill):
        return jnp.pad(v, (0, m2 - m_p), constant_values=fill)[None, :]

    # zero-padded lanes stay zero: their composite rows/cols are zero and
    # their bounds are [0, 0]
    ins = [spec.alpha.astype(dt).reshape(1),
           pad(state.x, n2), pad(state.y, m2), pad(state.z, m2),
           pad(qcat[:, :n_p], n2), pad(qcat[:, n_p:], m2),
           pad(l, m2), pad(u, m2),
           padrow(spec.rho, 1.0), padrow(spec.rho_inv, 1.0)]
    mats = [padm(spec.Gxc[:, :n_p], n2, n2), padm(spec.Gsc[:, :n_p], m2, n2),
            padm(spec.Gxc[:, n_p:], n2, m2), padm(spec.Gsc[:, n_p:], m2, m2)]
    split = _prec.get_matmul_precision() == "high" and dt == jnp.float32
    if split:
        mats = [h for mat in mats for h in _split_bf16(mat)]

    tile = lambda cols: pl.BlockSpec((bt, cols), lambda i: (i, 0))
    full = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    in_specs = ([full(ins[0])]
                + [tile(a.shape[1]) for a in ins[1:8]]
                + [full(ins[8]), full(ins[9])]
                + [full(a) for a in mats])
    out_shape = (jax.ShapeDtypeStruct((B_pad, n2), dt),
                 jax.ShapeDtypeStruct((B_pad, m2), dt),
                 jax.ShapeDtypeStruct((B_pad, m2), dt))

    x_o, y_o, z_o = pl.pallas_call(
        functools.partial(_admm_kernel, iters=iters, split=split),
        grid=(B_pad // bt,),
        in_specs=in_specs,
        out_specs=(tile(n2), tile(m2), tile(m2)),
        out_shape=out_shape,
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=1),
        backend="triton",
        interpret=interpret,
        name="admm_fused",
    )(*ins, *mats)

    x, y, z = x_o[:B, :n_p], y_o[:B, :m_p], z_o[:B, :m_p]
    # scaled KKT residuals, per instance (as qp.admm_solve)
    r_prim = jnp.max(jnp.abs(mm(x, spec.As.T) - z), axis=1)
    r_dual = jnp.max(jnp.abs(mm(x, spec.Ps.T) + q + mm(y, spec.As)), axis=1)
    return ADMMSolution(z_primal=x * spec.D[None, :],
                        state=ADMMState(x=x, y=y, z=z),
                        r_prim=r_prim, r_dual=r_dual)
