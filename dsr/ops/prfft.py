"""Perfect-reconstruction FFT filterbank (JAX).

JAX counterpart of `golden/prfft.py` (reference
`btk/modulated/PerfectReconstructionFFT{Analysis,Synthesis}Bank`
[K, SURVEY.md §2.1]): windowed-FFT analysis with hop D | M and a self-dual
COLA window, giving EXACT reconstruction — the complement of the
oversampled least-squares DFT bank in `ops/filterbank.py` (≈ −80 dB PR).
Critically sampled at D = M.

Design: frames are one strided reshape + broadcast window multiply and
a batched rfft (large static shapes, accelerator-friendly); the synthesis
overlap-add is `ops/filterbank`'s shifted-slice sum (D divides M).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dsr.ops.filterbank import overlap_add_frames
from golden import prfft as _golden

design_cola_window = _golden.design_cola_window
num_frames = _golden.num_frames


@functools.partial(jax.jit, static_argnames=("M", "D", "T"))
def _analysis_impl(x, window, *, M: int, D: int, T: int):
    S = x.shape[-1]
    P = M - D
    total = T * D + M
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(P, total - P - S)])
    idx = np.arange(T)[:, None] * D + np.arange(M)[None, :]
    frames = xp[..., idx] * window
    return jnp.fft.rfft(frames, axis=-1)


def analysis(x: jnp.ndarray, M: int, D: int,
             window: np.ndarray | None = None) -> jnp.ndarray:
    """(..., S) → (..., T, M//2+1) complex64."""
    if window is None:
        window = design_cola_window(M, D)
    T = num_frames(x.shape[-1], M, D)
    return _analysis_impl(jnp.asarray(x, jnp.float32),
                          jnp.asarray(window, jnp.float32), M=M, D=D, T=T)


@functools.partial(jax.jit, static_argnames=("M", "D", "out_len"))
def _synthesis_impl(A, window, *, M: int, D: int, out_len: int):
    v = jnp.fft.irfft(A, M, axis=-1) * window
    y = overlap_add_frames(v.reshape(*v.shape[:-1], M // D, D))
    y = jnp.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, D)])   # (..., T·D + M)
    P = M - D
    return jax.lax.dynamic_slice_in_dim(y, P, out_len, axis=-1)


def synthesis(A: jnp.ndarray, M: int, D: int, out_len: int,
              window: np.ndarray | None = None) -> jnp.ndarray:
    """(..., T, M//2+1) → (..., out_len) float32."""
    if window is None:
        window = design_cola_window(M, D)
    return _synthesis_impl(A, jnp.asarray(window, jnp.float32),
                           M=M, D=D, out_len=out_len)
