"""The simulated lossy channel as pre-drawn mask tensors.

The reference draws two Bernoulli gates per step from dedicated RNG streams
(e.g. ``Example_of_Tube_Tracking_MPC_Over_Lossy_Network.py:119-131``) with
the t=0 transmissions forced successful (:121-123,
``results_linear_system.py:211-215``).  Here the whole channel is data: a
``(T,)`` or ``(batch, T)`` int32 mask per direction, drawn up front with
``jax.random`` — which is exactly what makes the protocol a deterministic
scanned function and the rollouts vmappable (SURVEY.md section 7.1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["draw_loss_masks", "draw_disturbances"]


def draw_loss_masks(key: jax.Array, T: int, p_c2p, p_p2c,
                    batch_shape=()) -> tuple:
    """Returns ``(theta, gamma)`` int32 masks of shape ``batch_shape + (T,)``.

    ``theta[t] = 1`` means the controller->plant packet at step t arrives
    (loss prob ``p_c2p``); ``gamma[t]`` likewise plant->controller.
    ``t = 0`` is always forced to 1 (reference convention).  ``p_*`` may be
    scalars or arrays broadcastable to ``batch_shape`` (one loss probability
    per batch element — the Monte-Carlo sweep axis).
    """
    k_theta, k_gamma = jax.random.split(key)
    shape = tuple(batch_shape) + (T,)
    p_c2p = jnp.broadcast_to(jnp.asarray(p_c2p), tuple(batch_shape))[..., None]
    p_p2c = jnp.broadcast_to(jnp.asarray(p_p2c), tuple(batch_shape))[..., None]
    # draws pinned to float32 so realizations are identical across
    # backends/dtypes (under x64 the default uniform dtype silently
    # becomes f64 and produces DIFFERENT bits from the same key — which
    # made f64-CPU truth runs and f32 accelerator runs unpaired
    # experiments)
    p_c2p = p_c2p.astype(jnp.float32)
    p_p2c = p_p2c.astype(jnp.float32)
    theta = (jax.random.uniform(k_theta, shape, jnp.float32)
             >= p_c2p).astype(jnp.int32)
    gamma = (jax.random.uniform(k_gamma, shape, jnp.float32)
             >= p_p2c).astype(jnp.int32)
    force = jnp.ones(shape[:-1] + (1,), jnp.int32)
    theta = jnp.concatenate([force, theta[..., 1:]], axis=-1)
    gamma = jnp.concatenate([force, gamma[..., 1:]], axis=-1)
    return theta, gamma


def draw_disturbances(key: jax.Array, T: int, w_lo, w_hi,
                      batch_shape=()) -> jax.Array:
    """Uniform draws from the box disturbance set W = [w_lo, w_hi]^nx,
    shape ``batch_shape + (T, nx)`` (reference: per-dimension uniforms,
    ``results_linear_system.py:229-233``)."""
    w_lo = jnp.asarray(w_lo)
    w_hi = jnp.asarray(w_hi)
    nx = w_lo.shape[-1]
    shape = tuple(batch_shape) + (T, nx)
    # f32 draws for cross-backend realization parity (see draw_loss_masks)
    u = jax.random.uniform(key, shape, jnp.float32)
    return w_lo + u * (w_hi - w_lo)
