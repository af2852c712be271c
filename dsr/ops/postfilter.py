"""Post-beamformer enhancement (Zelinski, McCowan, masks, APAB).

Numerics match `golden/postfilter.py` (reference `btk/postfilter/` [K]).
Design: pair sums collapse to closed forms where possible —
Σ_{i<j} Re(X_i X_j*) = ½(|Σ_i X_i|² − Σ_i |X_i|²) — and the recursive PSD
smoothing is a `lax.scan` over frames; everything is batched over
(T, K) with no per-pair Python work at trace time except McCowan's
Γ-weighted pair gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def smooth(vals: jnp.ndarray, alpha: float) -> jnp.ndarray:
    """First-order recursive smoothing along axis 0 (frames)."""

    def step(acc, x):
        acc = alpha * acc + (1 - alpha) * x
        return acc, acc

    _, out = jax.lax.scan(step, vals[0], vals[1:])
    return jnp.concatenate([vals[:1], out], axis=0)


@jax.jit
def zelinski_weights(X: jnp.ndarray, alpha: float = 0.8, floor: float = 0.1) -> jnp.ndarray:
    """X: (N, T, K) → gain (T, K)."""
    N = X.shape[0]
    auto_inst = jnp.mean(jnp.abs(X) ** 2, axis=0)
    sum_x = jnp.sum(X, axis=0)
    cross_inst = 0.5 * (jnp.abs(sum_x) ** 2 - jnp.sum(jnp.abs(X) ** 2, axis=0))
    npairs = N * (N - 1) / 2
    auto = smooth(auto_inst, alpha)
    cross = smooth(cross_inst / npairs, alpha)
    return jnp.clip(cross / jnp.maximum(auto, 1e-12), floor, 1.0)


# smooth() runs over axis 0; for (N, T, K) per-channel smoothing we vmap.
_smooth_ch = jax.jit(jax.vmap(smooth, in_axes=(0, None)))


@jax.jit
def mccowan_weights(X: jnp.ndarray, Gamma: jnp.ndarray, alpha: float = 0.8, floor: float = 0.1):
    """X: (N, T, K); Gamma: (K, N, N) → gain (T, K)."""
    N = X.shape[0]
    ii, jj = np.triu_indices(N, k=1)
    phi_auto = _smooth_ch(jnp.abs(X) ** 2, alpha)               # (N, T, K)
    phi_ij = _smooth_ch(jnp.real(X[ii] * jnp.conj(X[jj])), alpha)  # (P, T, K)
    g = jnp.clip(jnp.real(Gamma[:, ii, jj]).T, -0.99, 0.99)     # (P, K)
    num = (phi_ij - 0.5 * g[:, None, :] * (phi_auto[ii] + phi_auto[jj])) / (1.0 - g[:, None, :])
    den = jnp.mean(phi_auto, axis=0)
    H = jnp.mean(num, axis=0) / jnp.maximum(den, 1e-12)
    return jnp.clip(H, floor, 1.0)


@jax.jit
def binary_mask(Y_target: jnp.ndarray, Y_ref: jnp.ndarray, floor: float = 0.05) -> jnp.ndarray:
    mask = (jnp.abs(Y_target) >= jnp.abs(Y_ref)).astype(jnp.float32)
    return jnp.maximum(mask, floor)


@jax.jit
def apab_weights(Y: jnp.ndarray, Z: jnp.ndarray, alpha: float = 0.8, floor: float = 0.1) -> jnp.ndarray:
    phi_y = smooth(jnp.abs(Y) ** 2, alpha)
    phi_z = smooth(jnp.abs(Z) ** 2, alpha)
    return jnp.clip(1.0 - phi_z / jnp.maximum(phi_y, 1e-12), floor, 1.0)


def apply_postfilter(Y: jnp.ndarray, H: jnp.ndarray) -> jnp.ndarray:
    return Y * H.astype(Y.real.dtype)


@jax.jit
def lefkimmiatis_weights(
    X: jnp.ndarray,
    Gamma: jnp.ndarray,
    w: jnp.ndarray,
    alpha: float = 0.8,
    floor: float = 0.1,
) -> jnp.ndarray:
    """Lefkimmiatis post-filter: McCowan's speech-PSD estimate with the
    Wiener gain formed from the diffuse-noise PSD at the *beamformer
    output* (w^H Γ w).  Numerics match `golden.postfilter.lefkimmiatis_weights`.

    X: (N, T, K); Gamma: (K, N, N); w: (K, N) → gain (T, K).
    """
    N = X.shape[0]
    ii, jj = np.triu_indices(N, k=1)
    phi_auto = _smooth_ch(jnp.abs(X) ** 2, alpha)                    # (N, T, K)
    phi_ij = _smooth_ch(jnp.real(X[ii] * jnp.conj(X[jj])), alpha)    # (P, T, K)
    g = jnp.clip(jnp.real(Gamma[:, ii, jj]).T, -0.99, 0.99)          # (P, K)
    num = (phi_ij - 0.5 * g[:, None, :] * (phi_auto[ii] + phi_auto[jj])) / (1.0 - g[:, None, :])
    phi_ss = jnp.maximum(jnp.mean(num, axis=0), 0.0)                 # (T, K)
    phi_nn = jnp.maximum(jnp.mean(phi_auto, axis=0) - phi_ss, 0.0)
    wgw = jnp.real(jnp.einsum("kn,knm,km->k", jnp.conj(w), Gamma.astype(w.dtype), w))
    wgw = jnp.maximum(wgw, 1e-6)[None, :]
    H = phi_ss / jnp.maximum(phi_ss + wgw * phi_nn, 1e-12)
    return jnp.clip(H, floor, 1.0)
