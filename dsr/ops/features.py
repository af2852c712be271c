"""ASR feature front end (MFCC chain, VTLN, CMN, deltas).

Numerics match `golden/features.py`.  Design: the whole chain is matmuls
and elementwise ops — mel projection and DCT are (T, bins) @ (bins, mel)
matmuls batched over utterances; framing is a static gather; deltas are
shift-adds.  The subband path (`mfcc_from_subbands`) feeds beamformed
subband power directly into the mel matrix with no resynthesis round trip
(SURVEY.md §3.2 chain, reference `CepstralFeature ← ... ← SpectralPower`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from golden.features import dct_matrix, mel_filterbank  # design-time, NumPy


@functools.lru_cache(maxsize=64)
def _mel_dct(
    num_mel: int, num_ceps: int, nbins: int, bin_hz: float, fmin: float, fmax: float, warp: float
):
    freqs = np.arange(nbins) * bin_hz
    W = mel_filterbank(num_mel, freqs, fmin, fmax, warp).astype(np.float32)
    C = dct_matrix(num_ceps, num_mel).astype(np.float32)
    return W, C


def _frame_idx(S: int, frame_len: int, hop: int) -> np.ndarray:
    T = max(0, 1 + (S - frame_len) // hop)
    return (np.arange(T)[:, None] * hop + np.arange(frame_len)[None, :]).astype(np.int32)


# The mel and DCT products run at full float32 precision: with TF32 (the
# GPU's default for float32 matmuls) the log compresses the mel energies'
# relative error into 6e-2 absolute cepstral error against golden/
# (measured on an H100; 1.2e-5 at HIGHEST).
_HI = jax.lax.Precision.HIGHEST


def _mel_cepstra(P, W, C):
    mel_e = jnp.maximum(jnp.matmul(P, W.T, precision=_HI), 1e-10)
    return jnp.matmul(jnp.log(mel_e), C.T, precision=_HI)


@functools.partial(jax.jit, static_argnames=("frame_len", "hop", "nfft", "preemph"))
def _mfcc_impl(x, W, C, idx, *, frame_len, hop, nfft, preemph):
    xp = jnp.concatenate([x[..., :1], x[..., 1:] - preemph * x[..., :-1]], axis=-1)
    frames = xp[..., idx] * jnp.asarray(np.hamming(frame_len).astype(np.float32))
    P = jnp.abs(jnp.fft.rfft(frames, nfft, axis=-1)) ** 2
    return _mel_cepstra(P, W, C)


def mfcc(
    x: jnp.ndarray,
    sample_rate: float = 16000.0,
    num_mel: int = 30,
    num_cepstra: int = 13,
    fmin: float = 20.0,
    fmax: float | None = None,
    preemph: float = 0.97,
    frame_len: int = 400,
    hop: int = 160,
    nfft: int = 512,
    vtln_warp: float = 1.0,
) -> jnp.ndarray:
    """Time-domain MFCC: (..., S) → (..., T, num_cepstra)."""
    fmax = sample_rate / 2 if fmax is None else fmax
    W, C = _mel_dct(num_mel, num_cepstra, nfft // 2 + 1, sample_rate / nfft, fmin, fmax, vtln_warp)
    idx = _frame_idx(x.shape[-1], frame_len, hop)
    return _mfcc_impl(
        x, jnp.asarray(W), jnp.asarray(C), jnp.asarray(idx),
        frame_len=frame_len, hop=hop, nfft=nfft, preemph=preemph,
    )


@jax.jit
def _subband_mfcc_impl(Y, W, C):
    with jax.named_scope("mfcc"):
        return _mel_cepstra(jnp.abs(Y) ** 2, W, C)


def mfcc_from_subbands(
    Y: jnp.ndarray,
    M: int,
    sample_rate: float = 16000.0,
    num_mel: int = 30,
    num_cepstra: int = 13,
    fmin: float = 20.0,
    fmax: float | None = None,
    vtln_warp: float = 1.0,
) -> jnp.ndarray:
    """Subband-domain MFCC: (..., T, M//2+1) complex → (..., T, num_cepstra)."""
    fmax = sample_rate / 2 if fmax is None else fmax
    W, C = _mel_dct(num_mel, num_cepstra, M // 2 + 1, sample_rate / M, fmin, fmax, vtln_warp)
    return _subband_mfcc_impl(Y, jnp.asarray(W), jnp.asarray(C))


@jax.jit
def cmn(feats: jnp.ndarray) -> jnp.ndarray:
    """Per-utterance cepstral mean normalisation over the frame axis (-2)."""
    return feats - feats.mean(axis=-2, keepdims=True)


@functools.partial(jax.jit, static_argnames=("window",))
def deltas(feats: jnp.ndarray, window: int = 2) -> jnp.ndarray:
    """Regression deltas over ±window frames (edge replication), axis -2."""
    denom = 2 * sum(d * d for d in range(1, window + 1))
    T = feats.shape[-2]
    first = jnp.repeat(feats[..., :1, :], window, axis=-2)
    last = jnp.repeat(feats[..., -1:, :], window, axis=-2)
    padded = jnp.concatenate([first, feats, last], axis=-2)
    out = jnp.zeros_like(feats)
    for d in range(1, window + 1):
        out = out + d * (
            jax.lax.slice_in_dim(padded, window + d, window + d + T, axis=-2)
            - jax.lax.slice_in_dim(padded, window - d, window - d + T, axis=-2)
        )
    return out / denom


def add_deltas(feats: jnp.ndarray, window: int = 2) -> jnp.ndarray:
    """[c, Δc, ΔΔc] stacking along the feature axis."""
    d1 = deltas(feats, window)
    d2 = deltas(d1, window)
    return jnp.concatenate([feats, d1, d2], axis=-1)


@functools.partial(jax.jit, static_argnames=("left", "right"))
def splice(feats: jnp.ndarray, left: int = 3, right: int = 3) -> jnp.ndarray:
    """Adjacent-frame stacking (reference adjacent-stacking stage [K])."""
    T = feats.shape[-2]
    first = jnp.repeat(feats[..., :1, :], left, axis=-2)
    last = jnp.repeat(feats[..., -1:, :], right, axis=-2)
    padded = jnp.concatenate([first, feats, last], axis=-2)
    cols = [
        jax.lax.slice_in_dim(padded, off, off + T, axis=-2)
        for off in range(left + right + 1)
    ]
    return jnp.concatenate(cols, axis=-1)


@jax.jit
def spectral_subtraction(
    P: jnp.ndarray, noise_psd: jnp.ndarray, alpha: float = 1.0, floor: float = 0.1
) -> jnp.ndarray:
    """Power-domain spectral subtraction with flooring (reference
    spectral-subtraction stage in btk/feature [K])."""
    return jnp.maximum(P - alpha * noise_psd, floor * P)
