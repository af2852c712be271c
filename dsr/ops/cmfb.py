"""Cosine-modulated filterbank (matches golden/cmfb.py).

Design: analysis is ONE (T, L) @ (L, M) matmul per batch (the
cosine modulation bakes into the filter matrix); synthesis is (T, M) @
(M, L) plus the standard static scatter overlap-add.  Real subbands —
convenient for real-valued subband processing chains.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from golden.cmfb import CmfbDesign, design  # design-time (NumPy)


@functools.partial(jax.jit, static_argnames=("M", "L", "T"))
def _analysis_impl(x, ha_rev, *, M: int, L: int, T: int):
    S = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(L - 1, T * M + L - S)]
    xp = jnp.pad(x, pad)
    hop_views = [
        xp[..., j * M : j * M + T * M].reshape(*x.shape[:-1], T, M)
        for j in range(L // M)
    ]
    frames = jnp.concatenate(hop_views, axis=-1)        # (..., T, L)
    return frames @ ha_rev                              # (..., T, M)


def analysis(x: jnp.ndarray, d: CmfbDesign) -> jnp.ndarray:
    """(..., S) → (..., T, M) real subbands."""
    M, L = d.M, d.ha.shape[1]
    S = x.shape[-1]
    T = -(-(S + L) // M) + L // M
    ha_rev = jnp.asarray(np.ascontiguousarray(d.ha[:, ::-1].T), jnp.float32)  # (L, M)
    return _analysis_impl(jnp.asarray(x, jnp.float32), ha_rev, M=M, L=L, T=T)


@functools.partial(jax.jit, static_argnames=("M", "L", "out_len", "delay"))
def _synthesis_impl(U, hs, *, M: int, L: int, out_len: int, delay: int):
    T = U.shape[-2]
    W = U @ hs                                          # (..., T, L)
    ylen = (T - 1) * M + L
    idx = (np.arange(T)[:, None] * M + np.arange(L)[None, :]).reshape(-1)
    y = jnp.zeros((*U.shape[:-2], ylen), W.dtype)
    y = y.at[..., idx].add(W.reshape(*U.shape[:-2], T * L))
    return jax.lax.dynamic_slice_in_dim(y, delay, out_len, axis=-1)


def synthesis(U: jnp.ndarray, d: CmfbDesign, out_len: int) -> jnp.ndarray:
    """(..., T, M) → (..., out_len) with design delay/gain compensated."""
    M, L = d.M, d.hs.shape[1]
    hs = jnp.asarray(d.hs / d.gain, jnp.float32)
    return _synthesis_impl(jnp.asarray(U, jnp.float32), hs, M=M, L=L,
                           out_len=out_len, delay=d.delay)
