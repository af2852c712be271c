"""Subband AEC (NLMS + Kalman) and voice-prompt cancellation.

Numerics match `golden/aec.py` (reference `btk/aec/`, `btk/cancelVP/` [K]).
Design: one `lax.scan` over frames; the carry holds the (K, taps)
filter/covariance and far-end history; each step is (K, taps) elementwise work
vectorised over all subbands at once.  `cancel_voice_prompt` is the same
NLMS machinery with the prompt as the far-end reference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("taps",))
def nlms_aec(D, F, taps: int = 4, mu: float = 0.5, eps: float = 1e-6):
    """D, F: (T, K) complex → (E (T, K), W (K, taps))."""
    K = D.shape[1]

    def step(carry, df):
        W, hist = carry
        d, f = df
        hist = jnp.roll(hist, 1, axis=1).at[:, 0].set(f)
        yhat = jnp.sum(jnp.conj(W) * hist, axis=1)
        e = d - yhat
        norm = jnp.sum(jnp.abs(hist) ** 2, axis=1) + eps
        W = W + mu * hist * jnp.conj(e)[:, None] / norm[:, None]
        return (W, hist), e

    W0 = jnp.zeros((K, taps), D.dtype)
    h0 = jnp.zeros((K, taps), D.dtype)
    (W, _), E = jax.lax.scan(step, (W0, h0), (D, F))
    return E, W


@functools.partial(jax.jit, static_argnames=("taps",))
def kalman_aec(D, F, taps: int = 4, q: float = 1e-4, r0: float = 1e-2):
    """Diagonal-covariance per-subband Kalman AEC (golden parity)."""
    K = D.shape[1]

    def step(carry, df):
        W, P, hist = carry
        d, f = df
        hist = jnp.roll(hist, 1, axis=1).at[:, 0].set(f)
        P = P + q
        yhat = jnp.sum(jnp.conj(W) * hist, axis=1)
        e = d - yhat
        S = jnp.sum(P * jnp.abs(hist) ** 2, axis=1) + r0
        gain = P * hist / S[:, None].astype(hist.dtype)
        W = W + gain * jnp.conj(e)[:, None]
        P = jnp.maximum(P * (1.0 - P * jnp.abs(hist) ** 2 / S[:, None]), 1e-8)
        return (W, P, hist), e

    W0 = jnp.zeros((K, taps), D.dtype)
    P0 = jnp.full((K, taps), 0.1, jnp.float32)
    h0 = jnp.zeros((K, taps), D.dtype)
    (W, _, _), E = jax.lax.scan(step, (W0, P0, h0), (D, F))
    return E, W


def cancel_voice_prompt(D, prompt_subbands, taps: int = 4, mu: float = 0.5):
    """Barge-in: cancel the known playback prompt from the mic signal
    (reference `btk/cancelVP/` [K]) — NLMS with the prompt as far end."""
    return nlms_aec(D, prompt_subbands, taps=taps, mu=mu)
