"""Oversampled DFT analysis/synthesis filterbank.

Numerics identical to `golden/filterbank.py` (the conventions source of
truth; validated allclose in tests/test_filterbank.py).  Design:

  - No per-frame Python loop and no gathers: frames are built by reshaping
    the padded signal into D-sample blocks and stacking the m·r shifted
    block views (D = M/r divides L = m·M), which XLA lowers to cheap slices.
  - The polyphase fold is a reshape+sum fused with the window multiply;
    the DFT is an rFFT over the last axis (cuFFT on the GPU).
  - Synthesis overlap-add is a sum of m·r shifted block views — no
    scatter, no atomics, a fixed summation order.
  - Batched over arbitrary leading axes (channels, utterances) — frames and
    channels become batch dimensions, as SURVEY.md §7 mandates (streams →
    scanned/batched pure functions).
  - Everything is shape-static and jit-safe; `num_frames` is the only
    Python-level size computation.

Prototype design is offline (NumPy, golden module); designed pairs are
cached per (M, m, r, rolloff, joint_iters) in-process and on disk.

Capability parity: reference `btk/modulated/` OverSampledDFTAnalysisBank /
OverSampledDFTSynthesisBank (SURVEY.md §2.1 [K]; tree unavailable, §0).
"""

from __future__ import annotations

import functools
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from dsr.config import FilterbankConfig
from golden import filterbank as _golden

_CACHE_DIR = pathlib.Path(os.environ.get("DSR_CACHE", pathlib.Path(__file__).parent / "prototypes"))


@functools.lru_cache(maxsize=32)
def get_prototypes(cfg: FilterbankConfig) -> tuple[np.ndarray, np.ndarray, int]:
    """Designed (hf, gf, delay) for a config, memoised in-process and on disk."""
    key = f"proto-M{cfg.M}-m{cfg.m}-r{cfg.r}-b{cfg.rolloff:g}-j{cfg.joint_iters}.npz"
    path = _CACHE_DIR / key
    if path.exists():
        z = np.load(path)
        return z["hf"], z["gf"], int(z["delay"])
    hf, gf, delay = _golden.design_prototypes(
        cfg.M, cfg.m, cfg.r, joint_iters=cfg.joint_iters, rolloff=cfg.rolloff
    )
    try:
        _CACHE_DIR.mkdir(parents=True, exist_ok=True)
        np.savez(path, hf=hf, gf=gf, delay=delay)
    except OSError:
        pass
    return hf, gf, delay


def num_frames(num_samples: int, cfg: FilterbankConfig) -> int:
    """Frames produced by `analysis` for a signal of `num_samples` samples."""
    return _golden.num_frames(num_samples, cfg.M, cfg.m, cfg.r)


def _frames(xp: jnp.ndarray, T: int, L: int, D: int) -> jnp.ndarray:
    """(..., (T-1)*D + L) padded signal → (..., T, L) frames, gather-free."""
    mr = L // D
    blocks = xp.reshape(*xp.shape[:-1], -1, D)  # (..., T + mr - 1, D)
    views = [blocks[..., j : j + T, :] for j in range(mr)]
    return jnp.concatenate(views, axis=-1)  # (..., T, mr*D = L)


@functools.partial(jax.jit, static_argnames=("M", "r", "T"))
def _analysis_impl(x, hf, *, M: int, r: int, T: int):
    L = hf.shape[-1]
    D = M // r
    P = L - D
    S = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(P, (T - 1) * D + L - P - S)]
    with jax.named_scope("filterbank_analysis"):
        xp = jnp.pad(x, pad)
        frames = _frames(xp, T, L, D)                   # (..., T, L)
        w = frames * hf                                 # window
        u = w.reshape(*w.shape[:-1], L // M, M).sum(-2)  # polyphase fold
        return jnp.fft.rfft(u, axis=-1)                 # (..., T, M/2+1)


def analysis(x: jnp.ndarray, cfg: FilterbankConfig, hf: np.ndarray | None = None) -> jnp.ndarray:
    """Subband analysis: (..., S) real → (..., T, M//2+1) complex64."""
    if hf is None:
        hf = get_prototypes(cfg)[0]
    hf = jnp.asarray(hf, jnp.result_type(x.dtype, jnp.float32))
    T = num_frames(x.shape[-1], cfg)
    return _analysis_impl(x, hf, M=cfg.M, r=cfg.r, T=T)


def overlap_add_frames(w: jnp.ndarray) -> jnp.ndarray:
    """(..., T, mr, D) frames of mr D-sample blocks → (..., (T+mr-1)·D).

    Block j of frame t lands on output block t + j, so output block b is
    the sum over j of frame b - j's block j: mr shifted, zero-padded views
    of the frames, added in a fixed order (no scatter)."""
    T, mr, D = w.shape[-3:]
    lead = [(0, 0)] * (w.ndim - 3)
    blocks = sum(jnp.pad(w[..., j, :], lead + [(j, mr - 1 - j), (0, 0)])
                 for j in range(mr))                    # (..., T+mr-1, D)
    return blocks.reshape(*blocks.shape[:-2], (T + mr - 1) * D)


@functools.partial(jax.jit, static_argnames=("M", "r", "delay", "out_len"))
def _synthesis_impl(A, gf, *, M: int, r: int, delay: int, out_len: int):
    L = gf.shape[-1]
    D = M // r
    P = L - D
    T = A.shape[-2]
    mr = L // D
    with jax.named_scope("synthesis"):
        v = jnp.fft.irfft(A, M, axis=-1)                # (..., T, M)
        tile = np.arange(L) % M
        w = gf * v[..., tile]                           # (..., T, L)
        y = overlap_add_frames(w.reshape(*w.shape[:-1], mr, D))
        return jax.lax.dynamic_slice_in_dim(y, P + delay, out_len, axis=-1)


def synthesis(
    A: jnp.ndarray,
    cfg: FilterbankConfig,
    out_len: int,
    gf: np.ndarray | None = None,
    delay: int | None = None,
) -> jnp.ndarray:
    """Subband synthesis: (..., T, M//2+1) complex → (..., out_len) real."""
    if gf is None or delay is None:
        _, gf_, delay_ = get_prototypes(cfg)
        gf = gf_ if gf is None else gf
        delay = delay_ if delay is None else delay
    real_dtype = jnp.float32 if A.dtype in (jnp.complex64,) else jnp.float64
    gf = jnp.asarray(gf, real_dtype)
    return _synthesis_impl(A, gf, M=cfg.M, r=cfg.r, delay=int(delay), out_len=out_len)
