"""Speaker tracking: iterated EKF over TDOA observation streams.

Numerics match `golden/tracking.py` (McDonough-Klee style IEKF, reference
tracker [K]).  Design: the whole trajectory is one `lax.scan` over TDOA
frames with (position, covariance) carry; each step is 3×3 / P×P solves.
The tracked position feeds steering delays for the beamformer (SURVEY.md
§3.5), closing the config-3 loop: GCC-PHAT → IEKF → steering → GSC.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from dsr.ops.tde import expected_tdoas, tdoa_jacobian


class TrackerState(NamedTuple):
    x: jnp.ndarray  # (3,) position
    P: jnp.ndarray  # (3, 3) covariance


@functools.partial(jax.jit, static_argnames=("iters",))
def iekf_step(state, tdoas, mics, pairs_i, pairs_j, q, r, c: float = 343.0, iters: int = 3):
    """One predict+update.  tdoas: (P,) seconds."""
    P_pred = state.P + q * jnp.eye(3)
    x0 = state.x
    R = r * jnp.eye(tdoas.shape[0])

    def it(_, xi):
        h = expected_tdoas(xi, mics, pairs_i, pairs_j, c)
        H = tdoa_jacobian(xi, mics, pairs_i, pairs_j, c)
        S = H @ P_pred @ H.T + R
        K = jnp.linalg.solve(S, H @ P_pred).T
        return x0 + K @ (tdoas - h - H @ (x0 - xi))

    xi = jax.lax.fori_loop(0, iters, it, x0)
    H = tdoa_jacobian(xi, mics, pairs_i, pairs_j, c)
    S = H @ P_pred @ H.T + R
    K = jnp.linalg.solve(S, H @ P_pred).T
    IKH = jnp.eye(3) - K @ H
    P_new = IKH @ P_pred @ IKH.T + K @ R @ K.T  # Joseph form
    return TrackerState(xi, P_new)


@functools.partial(jax.jit, static_argnames=("iters",))
def track(
    tdoa_seq: jnp.ndarray,
    x0: jnp.ndarray,
    P0: jnp.ndarray,
    mics: jnp.ndarray,
    pairs_i: jnp.ndarray,
    pairs_j: jnp.ndarray,
    q: float,
    r: float,
    c: float = 343.0,
    iters: int = 3,
) -> jnp.ndarray:
    """Track over a TDOA sequence (T, P) → positions (T, 3) via scan."""

    def step(state, tdoas):
        new = iekf_step(state, tdoas, mics, pairs_i, pairs_j, q, r, c, iters)
        return new, new.x

    _, xs = jax.lax.scan(step, TrackerState(x0, P0), tdoa_seq)
    return xs


def steering_delays_from_position(pos, mics, c: float = 343.0):
    """Tracked position → per-mic steering delays τ_n (seconds), the bridge
    into beamforming.steering_vectors (SURVEY.md §3.5)."""
    d = jnp.linalg.norm(mics - pos[None, :], axis=1)
    d0 = jnp.linalg.norm(pos)
    return (d - d0) / c


# ------------------------------------------------------------------ sqrt IEKF


class SqrtTrackerState(NamedTuple):
    x: jnp.ndarray  # (3,) position
    S: jnp.ndarray  # (3, 3) lower-triangular Cholesky factor, P = S Sᵀ


def _qr_lower(M: jnp.ndarray) -> jnp.ndarray:
    """Lower-triangular L with L Lᵀ = Mᵀ M (QR, diagonal made non-negative)."""
    R = jnp.linalg.qr(M, mode="r")
    s = jnp.where(jnp.diag(R) < 0, -1.0, 1.0)
    return (R * s[:, None]).T


@functools.partial(jax.jit, static_argnames=("iters",))
def iekf_step_sqrt(state, tdoas, mics, pairs_i, pairs_j, q, r, c: float = 343.0, iters: int = 3):
    """Square-root IEKF step: covariance carried as a Cholesky factor.

    Numerics match `golden/tracking.SqrtIekfTracker` (reference square-root
    Cholesky/Givens propagation, `btk/squareRoot/` [K]).  The Givens
    triangularisation is a QR of the Kailath pre-array — one small QR per
    frame, XLA-friendly, and P never formed across steps (the long-run
    conditioning win of the square-root form).
    """
    n = state.S.shape[0]
    m = tdoas.shape[0]
    S_pred = _qr_lower(jnp.vstack([state.S.T, jnp.sqrt(q) * jnp.eye(n)]))
    P_pred = S_pred @ S_pred.T
    x0 = state.x
    R = r * jnp.eye(m)

    def it(_, xi):
        h = expected_tdoas(xi, mics, pairs_i, pairs_j, c)
        H = tdoa_jacobian(xi, mics, pairs_i, pairs_j, c)
        Sy = H @ P_pred @ H.T + R
        K = jnp.linalg.solve(Sy, H @ P_pred).T
        return x0 + K @ (tdoas - h - H @ (x0 - xi))

    xi = jax.lax.fori_loop(0, iters, it, x0)
    H = tdoa_jacobian(xi, mics, pairs_i, pairs_j, c)
    pre = jnp.zeros((m + n, m + n))
    pre = pre.at[:m, :m].set(jnp.sqrt(r) * jnp.eye(m))
    pre = pre.at[:m, m:].set(H @ S_pred)
    pre = pre.at[m:, m:].set(S_pred)
    post = _qr_lower(pre.T)  # [[S_yy, 0], [K̄, S_post]]
    return SqrtTrackerState(xi, post[m:, m:])


@functools.partial(jax.jit, static_argnames=("iters",))
def track_sqrt(
    tdoa_seq: jnp.ndarray,
    x0: jnp.ndarray,
    S0: jnp.ndarray,
    mics: jnp.ndarray,
    pairs_i: jnp.ndarray,
    pairs_j: jnp.ndarray,
    q: float,
    r: float,
    c: float = 343.0,
    iters: int = 3,
) -> jnp.ndarray:
    """Square-root tracking over (T, P) TDOAs → positions (T, 3) via scan."""

    def step(state, tdoas):
        new = iekf_step_sqrt(state, tdoas, mics, pairs_i, pairs_j, q, r, c, iters)
        return new, new.x

    _, xs = jax.lax.scan(step, SqrtTrackerState(x0, S0), tdoa_seq)
    return xs
