"""Overlap-add / overlap-save FIR filtering.

Numerics match `golden/convolution.py` (reference `btk/convolution/` [K]).
Design: the block loop is a batched rFFT over all blocks at once; the
overlap-add recombination reuses the same static scatter-add the synthesis
filterbank uses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("block",))
def overlap_add(x: jnp.ndarray, h: jnp.ndarray, block: int = 1024) -> jnp.ndarray:
    """y = (h * x)[: len(x)] block-wise.  x: (..., S), h: (L,)."""
    S = x.shape[-1]
    L = h.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(block + L - 1)))
    nb = -(-S // block)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, nb * block - S)])
    blocks = xp.reshape(*x.shape[:-1], nb, block)
    H = jnp.fft.rfft(h, nfft)
    Y = jnp.fft.irfft(jnp.fft.rfft(blocks, nfft, axis=-1) * H, nfft, axis=-1)
    seg = block + L - 1
    idx = (np.arange(nb)[:, None] * block + np.arange(seg)[None, :]).reshape(-1)
    y = jnp.zeros((*x.shape[:-1], nb * block + nfft), Y.dtype)
    y = y.at[..., idx].add(Y[..., :seg].reshape(*x.shape[:-1], nb * seg))
    return y[..., :S]


@functools.partial(jax.jit, static_argnames=("block",))
def overlap_save(x: jnp.ndarray, h: jnp.ndarray, block: int = 1024) -> jnp.ndarray:
    """Same result as overlap_add, via the overlap-save formulation."""
    S = x.shape[-1]
    L = h.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(block + L - 1)))
    step = nfft - (L - 1)
    nb = -(-S // step)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(L - 1, nb * step + nfft - S)])
    # overlapping blocks: gather-free via static index matrix on the block axis
    idx = (np.arange(nb)[:, None] * step + np.arange(nfft)[None, :])
    blocks = xp[..., idx]                                   # (..., nb, nfft)
    H = jnp.fft.rfft(h, nfft)
    Y = jnp.fft.irfft(jnp.fft.rfft(blocks, nfft, axis=-1) * H, nfft, axis=-1)
    y = Y[..., L - 1 : L - 1 + step].reshape(*x.shape[:-1], nb * step)
    return y[..., :S]
