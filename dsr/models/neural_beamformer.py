"""Learned neural beamformer: mask-based MVDR front end (config 5).

A small recurrent/conv mask estimator predicts per-bin speech/noise masks
from multi-channel subband magnitudes; masked spatial covariance matrices
give time-invariant MVDR weights per utterance (the standard neural
beamforming recipe, re-built Design: PSDs are einsums over frames, the
per-bin solves are one batched `jnp.linalg.solve`).

Differentiable end-to-end: gradients flow through the MVDR solve into the
mask estimator, so it can be trained jointly with the Conformer-CTC AM.
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp


class MaskEstimator(nn.Module):
    """(…, T, K) log-magnitudes → (speech_mask, noise_mask) in [0, 1]."""

    hidden: int = 128

    @nn.compact
    def __call__(self, logmag):
        h = nn.Dense(self.hidden)(logmag)
        h = nn.relu(h)
        # temporal context via two dilated 1-D convs over frames
        h = nn.Conv(self.hidden, (5,), kernel_dilation=(1,), padding="SAME")(h)
        h = nn.relu(h)
        h = nn.Conv(self.hidden, (5,), kernel_dilation=(2,), padding="SAME")(h)
        h = nn.relu(h)
        K = logmag.shape[-1]
        ms = nn.sigmoid(nn.Dense(K, name="speech")(h))
        mn = nn.sigmoid(nn.Dense(K, name="noise")(h))
        return ms, mn


def masked_psd(X: jnp.ndarray, mask: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """X: (N, T, K); mask: (T, K) → Φ (K, N, N) mask-weighted PSD."""
    num = jnp.einsum("tk,ntk,mtk->knm", mask, X, jnp.conj(X))
    den = jnp.sum(mask, axis=0)[:, None, None] + eps
    return num / den.astype(num.dtype)


def mvdr_from_psds(
    phi_s: jnp.ndarray, phi_n: jnp.ndarray, ref: int = 0, loading: float = 1e-4
) -> jnp.ndarray:
    """Souden-style MVDR: w = (Φn⁻¹Φs / tr(Φn⁻¹Φs)) e_ref  → (K, N)."""
    N = phi_s.shape[-1]
    eye = jnp.eye(N, dtype=phi_n.dtype)
    tr_load = jnp.trace(jnp.real(phi_n), axis1=1, axis2=2)[:, None, None]
    phi_n_l = phi_n + loading * (tr_load / N) * eye
    nume = jnp.linalg.solve(phi_n_l, phi_s)                # (K, N, N)
    tr = jnp.trace(nume, axis1=1, axis2=2)[:, None]
    w_h = nume[..., ref] / (tr + 1e-8)                     # (K, N) = rows of wᴴ?
    return jnp.conj(w_h)                                   # beamformer weights w


class NeuralBeamformer(nn.Module):
    """Multi-channel subbands (N, T, K) → enhanced subbands (T, K)."""

    hidden: int = 128

    @nn.compact
    def __call__(self, X):
        logmag = jnp.log(jnp.mean(jnp.abs(X), axis=0) + 1e-6)  # (T, K)
        ms, mn = MaskEstimator(self.hidden)(logmag)
        phi_s = masked_psd(X, ms)
        phi_n = masked_psd(X, mn)
        w = mvdr_from_psds(phi_s, phi_n)
        return jnp.einsum("kn,ntk->tk", jnp.conj(w), X)
