"""LPC / warped-LPC / (warped-)MVDR envelope features.

Numerics match `golden/lpc.py` (Wölfel warped-MVDR front end, reference
`asr/feature/` [K]).  Design:

  - autocorrelation via rFFT (Wiener-Khinchin), batched over frames;
  - the warped autocorrelation's allpass chain is a `lax.scan` over time
    whose carry holds the whole cascade state — stages update as one
    vectorised ladder step, batched over frames;
  - Levinson-Durbin is a static-order `fori_loop` with masked dots
    (order ≈ 30 — scalar-ish, but tiny next to the spectral matmuls);
  - envelope evaluation and cepstra are (frames, order) @ (order, bins)
    matmuls.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from golden.features import dct_matrix


@functools.partial(jax.jit, static_argnames=("order",))
def autocorr(x: jnp.ndarray, order: int) -> jnp.ndarray:
    """Biased autocorrelation r[0..order] via FFT.  x: (..., n)."""
    n = x.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(2 * n)))
    X = jnp.fft.rfft(x, nfft, axis=-1)
    r = jnp.fft.irfft(jnp.abs(X) ** 2, nfft, axis=-1)[..., : order + 1]
    return r / n


@functools.partial(jax.jit, static_argnames=("order",))
def warped_autocorr(x: jnp.ndarray, order: int, lam: float = 0.4595) -> jnp.ndarray:
    """Warped autocorrelation r̃[0..order].  x: (..., n) → (..., order+1).

    One time-scan computes the whole allpass cascade:
      y_0[t] = x[t];  y_i[t] = -λ y_{i-1}[t] + y_{i-1}[t-1] + λ y_i[t-1]
    The carry holds (y_0[t-1], ..., y_order[t-1]); each step is a simple
    vectorised ladder recurrence over the stage axis via associative form:
      y_i[t] depends on y_{i-1}[t] (sequential in i) — expressed as a small
    static unrolled chain (order+1 fused multiply-adds per step).
    """
    batch_shape = x.shape[:-1]
    n = x.shape[-1]
    xt = jnp.moveaxis(x, -1, 0).reshape(n, -1)  # (n, B)

    def step(carry, xrow):
        # carry: (order+1, B) previous outputs of each stage
        prev = carry
        outs = [xrow]
        for i in range(1, order + 1):
            yi = -lam * outs[i - 1] + prev[i - 1] + lam * prev[i]
            outs.append(yi)
        cur = jnp.stack(outs)                 # (order+1, B)
        contrib = xrow[None, :] * cur         # x[t] * y_i[t]
        return cur, contrib

    init = jnp.zeros((order + 1, xt.shape[1]), x.dtype)
    _, contribs = jax.lax.scan(step, init, xt)  # (n, order+1, B)
    r = contribs.sum(axis=0) / n                # (order+1, B)
    return jnp.moveaxis(r, 0, -1).reshape(*batch_shape, order + 1)


@jax.jit
def levinson(r: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Levinson-Durbin, batched: r (..., p+1) → (a (..., p), err (...,))."""
    p = r.shape[-1] - 1
    B = r.shape[:-1]
    a0 = jnp.zeros((*B, p), r.dtype)
    err0 = r[..., 0]
    ar = jnp.arange(p)

    def body(i, carry):
        a, err = carry
        # acc = r[i] - sum_{j<i-1} a[j] * r[i-1-j]
        mask = ar < i - 1
        rj = jnp.take(r, jnp.clip(i - 1 - ar, 0, p), axis=-1)
        acc = jnp.take(r, i, axis=-1) - jnp.sum(jnp.where(mask, a * rj, 0.0), axis=-1)
        k = jnp.where(err > 0, acc / jnp.maximum(err, 1e-30), 0.0)
        # a_new[j] = a[j] - k*a[i-2-j] for j < i-1;  a_new[i-1] = k
        arev = jnp.take(a, jnp.clip(i - 2 - ar, 0, p - 1), axis=-1)
        a_new = jnp.where(mask, a - k[..., None] * arev, a)
        a_new = jnp.where(ar == i - 1, k[..., None], a_new)
        err_new = err * (1.0 - k * k)
        return a_new, err_new

    a, err = jax.lax.fori_loop(1, p + 1, body, (a0, err0))
    return a, jnp.maximum(err, 1e-20)


@functools.partial(jax.jit, static_argnames=("num_bins",))
def lpc_envelope(a: jnp.ndarray, err: jnp.ndarray, num_bins: int) -> jnp.ndarray:
    """All-pole spectrum on uniform ω ∈ [0, π].  a: (..., p) → (..., num_bins)."""
    p = a.shape[-1]
    b = jnp.concatenate([jnp.ones((*a.shape[:-1], 1), a.dtype), -a], axis=-1)
    w = np.linspace(0, np.pi, num_bins)
    ph = np.exp(-1j * w[:, None] * np.arange(p + 1)[None, :])  # (bins, p+1) static
    A = b @ jnp.asarray(ph.T.astype(np.complex64))             # (..., bins)
    return err[..., None] / jnp.maximum(jnp.abs(A) ** 2, 1e-20)


@functools.partial(jax.jit, static_argnames=("num_bins",))
def mvdr_envelope(a: jnp.ndarray, err: jnp.ndarray, num_bins: int) -> jnp.ndarray:
    """Musicus MVDR envelope, batched.  a: (..., p) → (..., num_bins)."""
    p = a.shape[-1]
    b = jnp.concatenate([jnp.ones((*a.shape[:-1], 1), a.dtype), -a], axis=-1)
    # mu[k] = sum_i (p+1-k-2i) b[i] b[i+k],  0 <= i <= p-k   (real b)
    i = np.arange(p + 1)
    k = np.arange(p + 1)
    wgt = (p + 1 - k[:, None] - 2 * i[None, :]).astype(np.float32)     # (k, i)
    valid = (i[None, :] <= p - k[:, None]).astype(np.float32)
    # shifted products: bb[k, i] = b[i] * b[i+k]
    idx = np.minimum(i[None, :] + k[:, None], p)                        # clamp, masked anyway
    b_shift = jnp.take(b, jnp.asarray(idx), axis=-1)                    # (..., k, i)
    bb = b[..., None, :] * b_shift
    mu = jnp.sum(bb * jnp.asarray(wgt * valid), axis=-1)                # (..., p+1)
    w = np.linspace(0, np.pi, num_bins)
    cos = np.cos(w[:, None] * k[None, :]).astype(np.float32)            # (bins, p+1)
    cos[:, 1:] *= 2.0
    S = mu @ jnp.asarray(cos.T)                                         # (..., bins)
    return err[..., None] / jnp.maximum(S, 1e-20)


def warped_mvdr_cepstra(
    frames: jnp.ndarray,
    order: int = 30,
    lam: float = 0.4595,
    num_bins: int = 129,
    num_cepstra: int = 13,
) -> jnp.ndarray:
    """Batched warped-MVDR cepstra: (..., T, n) frames → (..., T, num_cepstra)."""
    r = warped_autocorr(frames, order, lam)
    a, err = levinson(r)
    env = mvdr_envelope(a, err, num_bins)
    C = jnp.asarray(dct_matrix(num_cepstra, num_bins).astype(np.float32))
    return jnp.log(jnp.maximum(env, 1e-20)) @ C.T
