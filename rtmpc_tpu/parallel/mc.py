"""Monte-Carlo packet-loss sweeps as one batched computation.

The reference's Results scripts run nested Python loops: 10 loss
probabilities x 20 Monte-Carlo runs x 250 steps, one Clarabel solve at a
time (``results_linear_system.py:165-209``).  Here the whole sweep is a
single batched rollout: batch = (n_probs * n_mc) elements, each with its
own pre-drawn disturbance/loss realization, scanned over T and vmapped /
shard_mapped over the batch (SURVEY.md section 2.4: DP over rollouts is the
core parallel axis).

``run_mc_sweep`` reproduces the artifacts of the Results scripts:
per-(prob, mc) RMS tracking errors (NaN where an arm went infeasible, to be
filtered like ``results_linear_system.py:334-339``), infeasibility counts,
and sample trajectories per loss probability.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..models.specs import ControllerArrays, ControllerConfig
from ..protocol.network import draw_disturbances, draw_loss_masks
from .rollout import make_batched_rollout, tracking_error_rms

__all__ = ["MCSweepResult", "run_mc_sweep"]


@dataclasses.dataclass
class MCSweepResult:
    loss_probs: np.ndarray          # (P,)
    tracking_error: np.ndarray      # (P, M) RMS errors, NaN if infeasible
    infeasible_counts: np.ndarray   # (P,) number of infeasible MC runs
    sample_traj: np.ndarray         # (P, T, nx) trajectory of one MC run
    sample_x_nom: np.ndarray        # (P, T, nx)
    feasible: np.ndarray            # (P, M) bool
    wall_time_s: float = 0.0

    @property
    def n_mc(self) -> int:
        return self.tracking_error.shape[1]


def run_mc_sweep(
    arrays: ControllerArrays,
    cfg: ControllerConfig,
    *,
    T: int,
    n_mc: int,
    loss_probs,
    refs: np.ndarray,              # (T, nx) shared reference trajectory
    x0: np.ndarray,                # (nx,)
    w_lo, w_hi,                    # disturbance box
    key: jax.Array,
    actuator_mode: str = "consistent",
    infeas_mode: Optional[str] = None,     # None | "certificate"
    plant_step: Optional[Callable] = None,
    sample_mc_index: int = 5,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    n_chunks: int = 1,
    t_chunk: Optional[int] = None,
) -> MCSweepResult:
    """Run the full sweep; returns host-side numpy artifacts.

    ``sample_mc_index``: which MC run's trajectory to keep per probability
    (the reference keeps run ``min(5, N_MC-1)``,
    ``results_linear_system.py:298-301``).
    ``mesh``: optional ``jax.sharding.Mesh`` with axis "dp" to shard the
    batch across devices.

    Checkpoint / resume (the reference loses everything on a crash —
    in-memory dicts only, ``results_linear_system.py:151-157``): with
    ``checkpoint_path`` set and ``n_chunks > 1`` the batch is processed in
    chunks along the probability axis and the accumulator is flushed to an
    ``.npz`` after each chunk.  Re-running with the same path resumes after
    the last finished chunk.  All randomness derives from ``key`` up front,
    so chunking (and resuming) is bit-identical to a single-shot run.
    """
    import os
    import time as _time

    loss_probs = np.asarray(loss_probs, dtype=np.float64)
    P, M = len(loss_probs), int(n_mc)
    BATCH = P * M
    nx = cfg.nx
    dt = arrays.A.dtype

    k1, k2 = jax.random.split(key)
    p_flat = jnp.asarray(np.repeat(loss_probs, M))
    theta, gamma = draw_loss_masks(k1, T, p_flat, p_flat,
                                   batch_shape=(BATCH,))
    w = draw_disturbances(k2, T, np.asarray(w_lo), np.asarray(w_hi),
                          batch_shape=(BATCH,)).astype(dt)
    refs_b = jnp.broadcast_to(jnp.asarray(refs, dt), (BATCH, T, nx))
    x0_b = jnp.broadcast_to(jnp.asarray(x0, dt).reshape(nx), (BATCH, nx))

    # Time chunking: instead of splitting the batch (probability axis),
    # split the SCAN into t_chunk-step dispatches threading the rollout
    # carry between calls.  Bit-identical to the single-shot scan (the
    # carry is the scan state).
    if t_chunk is not None and cfg.solver == "pallas":
        raise ValueError("t_chunk is unsupported for the pallas batch path")

    roll = make_batched_rollout(arrays, cfg, T, actuator_mode=actuator_mode,
                                infeas_mode=infeas_mode,
                                plant_step=plant_step)

    def batched(x0b, refsb, wb, thetab, gammab):
        carry, outs = roll(x0b, refsb, wb, thetab, gammab)
        err = jax.vmap(tracking_error_rms)(
            x0b, outs.x, refsb, carry.feasible)
        return outs.x, outs.x_nom, err, carry.feasible

    fn = jax.jit(batched)

    if t_chunk is not None:
        from .rollout import init_carry, make_rollout_fn
        fn_elem = make_rollout_fn(arrays, cfg, T,
                                  actuator_mode=actuator_mode,
                                  infeas_mode=infeas_mode,
                                  plant_step=plant_step)
        fn_seg = jax.jit(jax.vmap(fn_elem, in_axes=(0, 0, 0, 0, 0, 0)))
        init_c = jax.jit(jax.vmap(
            lambda x: init_carry(arrays, cfg, x, T)))

        def rms_host(x0b, xs, refsb, feasible):
            traj = np.concatenate([np.asarray(x0b)[:, None],
                                   xs[:, :-1]], axis=1)
            e2 = np.sum((traj[:, :, 0] - np.asarray(refsb)[:, :, 0]) ** 2,
                        axis=1)
            e2 = e2 + np.sum(traj[:, :, 1:] ** 2, axis=(1, 2))
            e = np.sqrt(e2) / traj.shape[1]
            return np.where(feasible, e, np.nan)

        def fn(x0b, refsb, wb, thetab, gammab):      # noqa: F811
            carry = init_c(x0b)
            xs_p, xn_p = [], []
            for t0 in range(0, T, t_chunk):
                te = slice(t0, min(t0 + t_chunk, T))
                carry, outs = fn_seg(x0b, refsb[:, te], wb[:, te],
                                     thetab[:, te], gammab[:, te], carry)
                xs_p.append(to_host(outs.x))
                xn_p.append(to_host(outs.x_nom))
            xs = np.concatenate(xs_p, axis=1)
            xn = np.concatenate(xn_p, axis=1)
            feas = to_host(carry.feasible)
            return xs, xn, rms_host(x0b, xs, refsb, feas), feas

    def shard(a):
        if mesh is None:
            return a
        from jax.sharding import NamedSharding, PartitionSpec as Pspec
        return jax.device_put(a, NamedSharding(mesh, Pspec("dp")))

    def to_host(a):
        """Device->host for a possibly globally-sharded array.  In a
        multi-process run each process only holds its addressable shards;
        gather the full array so every process returns identical rows
        (cross-host traffic happens HERE, at result gather, per the §2.4
        plan)."""
        from .distributed import is_distributed
        if is_distributed():
            from jax.experimental import multihost_utils
            return np.asarray(
                multihost_utils.process_allgather(a, tiled=True))
        return np.asarray(a)

    # --- chunking / resume bookkeeping ---------------------------------
    n_chunks = max(1, min(int(n_chunks), P))
    bounds = np.linspace(0, P, n_chunks + 1).astype(int)  # prob-axis cuts
    start_chunk = 0
    err = np.full((P, M), np.nan)
    feas = np.zeros((P, M), bool)
    si = min(sample_mc_index, M - 1)
    sample_traj = np.zeros((P, T, nx))
    sample_x_nom = np.zeros((P, T, nx))
    wall = 0.0

    # The fingerprint must pin EVERYTHING that determines the result rows:
    # shapes, the full RNG key, the loss-probability values, the chunking
    # plan (a resume with different n_chunks would skip / misalign rows),
    # and the scenario inputs (x0, refs).  A content hash is the robust way.
    import hashlib
    hsh = hashlib.sha256()
    for part in (np.asarray(key, np.uint32), np.asarray([P, M, T, nx],
                                                        np.int64),
                 loss_probs, bounds,
                 np.asarray(x0, np.float64), np.asarray(refs, np.float64)):
        hsh.update(np.ascontiguousarray(part).tobytes())
    fingerprint = np.frombuffer(hsh.digest(), dtype=np.uint8)
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = np.load(checkpoint_path)
        if ck["fingerprint"].shape == fingerprint.shape and \
                np.array_equal(ck["fingerprint"], fingerprint):
            start_chunk = int(ck["next_chunk"])
            err, feas = ck["err"], ck["feas"]
            sample_traj, sample_x_nom = ck["sample_traj"], ck["sample_x_nom"]
            wall = float(ck["wall"])

    for ci in range(start_chunk, n_chunks):
        lo, hi = bounds[ci], bounds[ci + 1]
        if hi == lo:
            continue
        sl = slice(lo * M, hi * M)
        t0 = _time.perf_counter()
        xs_c, xn_c, err_c, feas_c = fn(
            shard(x0_b[sl]), shard(refs_b[sl]), shard(w[sl]),
            shard(theta[sl]), shard(gamma[sl]))
        jax.block_until_ready(xs_c)
        wall += _time.perf_counter() - t0
        print(f"  [mc] chunk {ci + 1}/{n_chunks} "
              f"(p={loss_probs[lo]:.2f}..{loss_probs[hi - 1]:.2f}) "
              f"{_time.perf_counter() - t0:.1f}s", flush=True)
        npp = hi - lo
        err[lo:hi] = to_host(err_c).reshape(npp, M)
        feas[lo:hi] = to_host(feas_c).reshape(npp, M)
        sample_traj[lo:hi] = to_host(xs_c).reshape(npp, M, T, nx)[:, si]
        sample_x_nom[lo:hi] = to_host(xn_c).reshape(npp, M, T, nx)[:, si]
        if checkpoint_path:
            tmp = checkpoint_path + ".tmp.npz"     # atomic write + rename
            np.savez(tmp, fingerprint=fingerprint, next_chunk=ci + 1,
                     err=err, feas=feas, sample_traj=sample_traj,
                     sample_x_nom=sample_x_nom, wall=wall)
            os.replace(tmp, checkpoint_path)

    return MCSweepResult(
        loss_probs=loss_probs,
        tracking_error=err,
        infeasible_counts=(~feas).sum(axis=1),
        sample_traj=sample_traj,
        sample_x_nom=sample_x_nom,
        feasible=feas,
        wall_time_s=wall,
    )
