"""Time-delay estimation and source localization.

Numerics match `golden/tde.py` (reference `btk/tde/` + `btk/localization/`
[K]).  Design:

  - GCC-PHAT over all mic pairs at once: (P, K) cross-spectra → one batched
    irfft → vectorised (parabolic) peak pick; no per-pair Python loops.
  - SRP-PHAT is a single (G, F) × (F, P) style contraction: the steering
    phases for the whole candidate grid form a matrix, so the grid search is
    a matmul against the PHAT cross-spectra.
  - Gauss-Newton localisation is a fixed-iteration `fori_loop` of tiny
    batched solves.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _parabolic_peak(cc):
    """cc: (..., L) → fractional peak index (…,)."""
    k = jnp.argmax(cc, axis=-1)
    L = cc.shape[-1]
    km = jnp.clip(k - 1, 0, L - 1)
    kp = jnp.clip(k + 1, 0, L - 1)
    y0 = jnp.take_along_axis(cc, km[..., None], -1)[..., 0]
    y1 = jnp.take_along_axis(cc, k[..., None], -1)[..., 0]
    y2 = jnp.take_along_axis(cc, kp[..., None], -1)[..., 0]
    denom = y0 - 2 * y1 + y2
    delta = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (y0 - y2) / denom, 0.0)
    interior = (k > 0) & (k < L - 1)
    return k + jnp.where(interior, delta, 0.0)


@functools.partial(jax.jit, static_argnames=("nfft", "interp", "max_shift"))
def _gcc_phat_pairs_impl(X, pairs_i, pairs_j, *, nfft, interp, max_shift):
    R = X[pairs_i] * jnp.conj(X[pairs_j])          # (P, K)
    R = R / jnp.maximum(jnp.abs(R), 1e-15)
    cc = jnp.fft.irfft(R, interp * nfft, axis=-1)  # (P, interp*nfft)
    cc = jnp.concatenate([cc[:, -max_shift:], cc[:, : max_shift + 1]], axis=-1)
    kf = _parabolic_peak(cc)
    return -(kf - max_shift), cc


def gcc_phat_pairs(
    x: jnp.ndarray,
    pairs: list[tuple[int, int]],
    sample_rate: float,
    max_tau: float,
    interp: int = 4,
) -> jnp.ndarray:
    """x: (N, S) → TDOA (P,) seconds for each (i, j) pair (all at once)."""
    S = x.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(2 * S)))
    X = jnp.fft.rfft(x, nfft, axis=-1)
    max_shift = min(int(interp * sample_rate * max_tau), interp * nfft // 2)
    pi = jnp.asarray([p[0] for p in pairs])
    pj = jnp.asarray([p[1] for p in pairs])
    lags, _ = _gcc_phat_pairs_impl(X, pi, pj, nfft=nfft, interp=interp, max_shift=max_shift)
    return lags / (interp * sample_rate)


@functools.partial(jax.jit, static_argnames=("interp", "M"))
def gcc_phat_subband_pairs(Y, pairs_i, pairs_j, *, M: int, interp: int = 8):
    """Subband GCC-PHAT: Y (N, T, K) analysis frames → lag samples (P,).

    Streaming form for the tracking front end; divide by sample_rate·interp
    for seconds (done by the caller, which knows fs).
    """
    R = jnp.sum(Y[pairs_i] * jnp.conj(Y[pairs_j]), axis=1)  # (P, K)
    R = R / jnp.maximum(jnp.abs(R), 1e-15)
    cc = jnp.fft.irfft(R, interp * M, axis=-1)
    half = interp * M // 2
    cc = jnp.concatenate([cc[:, -half:], cc[:, : half + 1]], axis=-1)
    kf = _parabolic_peak(cc)
    return -(kf - half)


def expected_tdoas(pos, mics, pairs_i, pairs_j, c):
    d = jnp.linalg.norm(mics - pos[None, :], axis=1)
    return (d[pairs_j] - d[pairs_i]) / c


def tdoa_jacobian(pos, mics, pairs_i, pairs_j, c):
    d = jnp.linalg.norm(mics - pos[None, :], axis=1)
    u = (pos[None, :] - mics) / jnp.maximum(d[:, None], 1e-9)
    return (u[pairs_j] - u[pairs_i]) / c


def srp_phat(
    x: jnp.ndarray,
    mics: np.ndarray,
    grid: np.ndarray,
    sample_rate: float,
    c: float = 343.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """SRP-PHAT as one matmul.  x: (N, S); grid: (G, 3) → (argmax pos, power).

    P(g) = Σ_p Re Σ_f Φ_p(f) e^{jω_f τ_p(g)} = Re[ E(g,·) · vec(Φ) ] with
    E the (G, P·F) steering matrix — evaluated as a matmul in f32 pairs.
    """
    N, S = x.shape
    nfft = 1 << int(np.ceil(np.log2(S)))
    X = jnp.fft.rfft(np.asarray(x), nfft, axis=-1)  # (N, F)
    pairs = [(i, j) for i in range(N) for j in range(i + 1, N)]
    pi = np.asarray([p[0] for p in pairs])
    pj = np.asarray([p[1] for p in pairs])
    Phi = X[pi] * jnp.conj(X[pj])
    Phi = Phi / jnp.maximum(jnp.abs(Phi), 1e-15)     # (P, F)
    f = np.arange(nfft // 2 + 1) * sample_rate / nfft
    # taus: (G, P) from geometry (host precompute, static grid)
    mics_np = np.asarray(mics)
    d = np.linalg.norm(mics_np[None, :, :] - np.asarray(grid)[:, None, :], axis=-1)  # (G, N)
    taus = (d[:, pj] - d[:, pi]) / c                 # (G, P)
    ang = 2 * np.pi * taus[..., None] * f[None, None, :]        # (G, P, F)
    cosm = jnp.asarray(np.cos(ang).reshape(len(grid), -1).astype(np.float32))
    sinm = jnp.asarray(np.sin(ang).reshape(len(grid), -1).astype(np.float32))
    re = jnp.real(Phi).reshape(-1)
    im = jnp.imag(Phi).reshape(-1)
    power = cosm @ re - sinm @ im
    best = jnp.asarray(grid)[jnp.argmax(power)]
    return best, power


@functools.partial(jax.jit, static_argnames=("iters",))
def ls_position(tdoas, mics, pairs_i, pairs_j, x0, c: float = 343.0, iters: int = 20):
    """Batched Gauss-Newton TDOA localisation (matches golden.ls_position)."""

    def body(_, x):
        h = expected_tdoas(x, mics, pairs_i, pairs_j, c)
        J = tdoa_jacobian(x, mics, pairs_i, pairs_j, c)
        r = tdoas - h
        JtJ = J.T @ J + 1e-12 * jnp.eye(3)
        dx = jnp.linalg.solve(JtJ, J.T @ r)
        return x + dx

    return jax.lax.fori_loop(0, iters, body, x0)


@jax.jit
def sx_position(tdoas0: jnp.ndarray, mics: jnp.ndarray, c: float = 343.0) -> jnp.ndarray:
    """Closed-form spherical-intersection (SX) source position.  Numerics
    match `golden.tde.sx_position` (see there for the derivation); branch
    selection is a masked `where` over the two quadratic roots so the
    whole solver jits to a handful of small dense ops (no iteration —
    unlike `ls_position` this needs no initial guess).

    tdoas0: (N-1,) TDOAs of mics 1..N-1 relative to mic 0; mics: (N, 3).
    """
    m0 = mics[0]
    M = mics[1:] - m0[None, :]
    d = c * tdoas0
    delta = 0.5 * (jnp.sum(M**2, axis=1) - d**2)
    W = jnp.linalg.pinv(M)
    a = W @ delta
    b = W @ d
    A = b @ b - 1.0
    Bq = -2.0 * (a @ b)
    Cq = a @ a
    disc = jnp.sqrt(jnp.maximum(Bq * Bq - 4.0 * A * Cq, 0.0))
    safe_A = jnp.where(jnp.abs(A) < 1e-9, 1.0, A)
    quad = jnp.stack([(-Bq + disc) / (2.0 * safe_A), (-Bq - disc) / (2.0 * safe_A)])
    lin = jnp.stack([Cq / jnp.maximum(-Bq, 1e-12)] * 2)
    roots = jnp.maximum(jnp.where(jnp.abs(A) < 1e-9, lin, quad), 0.0)  # (2,)
    xs = a[None, :] - roots[:, None] * b[None, :]                      # (2, 3)
    res = jnp.abs(jnp.linalg.norm(xs, axis=1) - roots)
    return xs[jnp.argmin(res)] + m0
