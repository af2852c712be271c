"""Subband beamformers: DS, superdirective MVDR, GSC (NLMS/RLS).

Numerics match `golden/beamforming.py` (validated in tests).  Design:

  - All weight computations are batched over the K subband bins — K×N×N
    batched solves / K×N manifold math, no per-bin Python loops.
  - GSC adaptation is a `lax.scan` over frames with the (K, N-1) active
    weights as carry; each step is a handful of (K, N) elementwise ops.  For
    throughput-critical paths `gsc_nlms_block` adapts once per block of
    frames (block-LMS), turning the inner work into large batched matmuls
    while keeping identical steady-state behaviour.
  - Complex arithmetic stays in complex64.

Capability parity: reference `btk/beamformer/` `SubbandDS`/`SubbandMVDR`/
`SubbandGSC(+RLS)` and `calcArrayManifoldVectors*` (SURVEY.md §2.1 [K]).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def subband_freqs(M: int, sample_rate: float) -> jnp.ndarray:
    return jnp.arange(M // 2 + 1) * (sample_rate / M)


@functools.partial(jax.jit, static_argnames=("M", "sample_rate"))
def steering_vectors(taus_sec: jnp.ndarray, M: int, sample_rate: float) -> jnp.ndarray:
    """Array manifold: (..., N) delays (sec) → (..., K, N) complex64."""
    f = subband_freqs(M, sample_rate)
    phase = -2.0 * jnp.pi * f[:, None] * taus_sec[..., None, :]
    return jax.lax.complex(jnp.cos(phase), jnp.sin(phase)).astype(jnp.complex64)


@jax.jit
def ds_weights(v: jnp.ndarray) -> jnp.ndarray:
    """Delay-and-sum: w = v / N (distortionless)."""
    return v / v.shape[-1]


def diffuse_coherence(
    mic_positions: np.ndarray, M: int, sample_rate: float, sound_speed: float
) -> jnp.ndarray:
    """Γ_ij(f_k) = sinc(2π f d_ij / c)  → (K, N, N) float32."""
    p = jnp.asarray(mic_positions)
    d = jnp.linalg.norm(p[:, None, :] - p[None, :, :], axis=-1)
    f = subband_freqs(M, sample_rate)
    x = 2.0 * jnp.pi * f[:, None, None] * d[None] / sound_speed
    return jnp.where(x == 0, 1.0, jnp.sin(x) / jnp.where(x == 0, 1.0, x)).astype(jnp.float32)


@jax.jit
def mvdr_weights(v: jnp.ndarray, Gamma: jnp.ndarray, loading: float = 1e-2) -> jnp.ndarray:
    """Superdirective MVDR, batched over bins: w = Γl⁻¹v / (vᴴΓl⁻¹v)."""
    N = v.shape[-1]
    Gl = (Gamma + loading * jnp.eye(N, dtype=Gamma.dtype)).astype(jnp.complex64)
    gv = jnp.linalg.solve(Gl, v[..., None])[..., 0]
    denom = jnp.sum(jnp.conj(v) * gv, axis=-1, keepdims=True)
    return gv / denom


@jax.jit
def mvdr_precompute(Gamma: jnp.ndarray, loading: float = 1e-2) -> jnp.ndarray:
    """Γl⁻¹ per bin — signal- AND steering-independent (geometry only).

    Hoists the K batched N×N solves out of the serving path: steering
    updates (e.g. from the tracker) then cost one batched matvec via
    `mvdr_weights_from_inv`.
    """
    N = Gamma.shape[-1]
    Gl = (Gamma + loading * jnp.eye(N, dtype=Gamma.dtype)).astype(jnp.complex64)
    return jnp.linalg.inv(Gl)


@jax.jit
def mvdr_weights_from_inv(v: jnp.ndarray, Gamma_inv: jnp.ndarray) -> jnp.ndarray:
    """w = Γl⁻¹v / (vᴴΓl⁻¹v) from the precomputed inverse (cheap matvec)."""
    gv = jnp.einsum("...knm,...km->...kn", Gamma_inv, v)
    denom = jnp.sum(jnp.conj(v) * gv, axis=-1, keepdims=True)
    return gv / denom


@jax.jit
def blocking_matrix(v: jnp.ndarray) -> jnp.ndarray:
    """Householder complement of v per bin: (K, N) → (K, N, N-1).

    Identical closed form to golden.beamforming.blocking_matrix.
    """
    N = v.shape[-1]
    vn = v / jnp.linalg.norm(v, axis=-1, keepdims=True)
    v0 = vn[..., 0]
    phi = jnp.where(jnp.abs(v0) > 1e-12, v0 / jnp.maximum(jnp.abs(v0), 1e-30), 1.0 + 0j)
    u = vn.at[..., 0].add(phi)
    uu = jnp.sum(jnp.abs(u) ** 2, axis=-1)
    H = jnp.eye(N, dtype=v.dtype) - 2.0 * u[..., :, None] * jnp.conj(u[..., None, :]) / uu[..., None, None]
    return H[..., :, 1:]


@jax.jit
def apply_weights(X: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """y[..., t, k] = w_kᴴ X[..., :, t, k].  X: (..., N, T, K), w: (..., K, N)."""
    with jax.named_scope("beamform_apply"):
        return jnp.einsum("...kn,...ntk->...tk", jnp.conj(w), X)


def ds_beamform(X: jnp.ndarray, taus_sec: jnp.ndarray, M: int,
                sample_rate: float) -> jnp.ndarray:
    """Fused fractional-delay steering + delay-and-sum (HOT LOOP of
    SURVEY.md §3.1/§3.5): X (N, T, K) complex, taus (N,) static or (T, N)
    per-frame trajectory (tracking front end) → (T, K).

    Equals `apply_weights(X, ds_weights(steering_vectors(...)))` per frame.
    """
    taus = jnp.asarray(taus_sec, jnp.float32)
    if taus.ndim == 1:
        v = steering_vectors(taus, M, sample_rate)
        return apply_weights(X, ds_weights(v))
    v_t = steering_vectors(taus, M, sample_rate)         # (T, K, N)
    return jnp.einsum("tkn,ntk->tk", jnp.conj(v_t), X) / X.shape[0]


@jax.jit
def _gsc_scan(X_tkn, wq, B, mu, eps, cap, wa0):
    """Sequential NLMS over frames.  X_tkn: (T, K, N)."""
    if wa0 is None:
        wa0 = jnp.zeros((wq.shape[0], wq.shape[1] - 1), dtype=wq.dtype)

    def step(wa, x):  # x: (K, N)
        yc = jnp.sum(jnp.conj(wq) * x, axis=-1)                  # (K,)
        z = jnp.einsum("knm,kn->km", jnp.conj(B), x)             # (K, N-1)
        y = yc - jnp.sum(jnp.conj(wa) * z, axis=-1)              # (K,)
        znorm = jnp.sum(jnp.abs(z) ** 2, axis=-1, keepdims=True)
        wa_new = wa + mu * z * jnp.conj(y)[:, None] / (znorm + eps)
        nrm = jnp.linalg.norm(wa_new, axis=-1, keepdims=True)
        wa_new = wa_new * jnp.minimum(1.0, cap / jnp.maximum(nrm, 1e-30))
        return wa_new, y

    wa_final, Y = jax.lax.scan(step, wa0, X_tkn)
    return Y, wa_final


def gsc_nlms(
    X: jnp.ndarray,
    wq: jnp.ndarray,
    B: jnp.ndarray,
    mu: float = 0.1,
    eps: float = 1e-6,
    wa_norm_cap: float = 10.0,
    wa0: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """GSC-NLMS, exact frame-sequential path.

    X: (N, T, K) → (Y: (T, K), wa: (K, N-1)).  State `wa0` can be threaded
    across chunks for streaming (SURVEY.md §5 long-context: chunked scan
    with carried adaptive-weight state).
    """
    X_tkn = jnp.transpose(X, (1, 2, 0))  # (T, K, N)
    return _gsc_scan(
        X_tkn,
        wq,
        B,
        jnp.float32(mu),
        jnp.float32(eps),
        jnp.float32(wa_norm_cap),
        wa0,
    )


@functools.partial(jax.jit, static_argnames=("block",))
def _gsc_block_impl(X_tkn, wq, B, mu, eps, cap, wa0, *, block: int):
    if wa0 is None:
        wa0 = jnp.zeros((wq.shape[0], wq.shape[1] - 1), dtype=wq.dtype)
    T = X_tkn.shape[0]
    nb = T // block
    Xb = X_tkn[: nb * block].reshape(nb, block, *X_tkn.shape[1:])

    def step(wa, xb):  # xb: (block, K, N)
        yc = jnp.sum(jnp.conj(wq) * xb, axis=-1)                     # (block, K)
        z = jnp.einsum("knm,bkn->bkm", jnp.conj(B), xb)              # (block, K, N-1)
        y = yc - jnp.einsum("km,bkm->bk", jnp.conj(wa), z)           # (block, K)
        znorm = jnp.sum(jnp.abs(z) ** 2, axis=(0, 2)) / block        # (K,)
        grad = jnp.einsum("bkm,bk->km", z, jnp.conj(y)) / block
        wa_new = wa + mu * grad / (znorm[:, None] + eps)
        nrm = jnp.linalg.norm(wa_new, axis=-1, keepdims=True)
        wa_new = wa_new * jnp.minimum(1.0, cap / jnp.maximum(nrm, 1e-30))
        return wa_new, y

    wa_final, Y = jax.lax.scan(step, wa0, Xb)
    Y = Y.reshape(nb * block, -1)
    if nb * block < T:  # tail frames with frozen weights
        xt = X_tkn[nb * block :]
        yc = jnp.sum(jnp.conj(wq) * xt, axis=-1)
        z = jnp.einsum("knm,bkn->bkm", jnp.conj(B), xt)
        yt = yc - jnp.einsum("km,bkm->bk", jnp.conj(wa_final), z)
        Y = jnp.concatenate([Y, yt], axis=0)
    return Y, wa_final


def gsc_nlms_block(
    X: jnp.ndarray,
    wq: jnp.ndarray,
    B: jnp.ndarray,
    mu: float = 0.1,
    eps: float = 1e-6,
    wa_norm_cap: float = 10.0,
    wa0: jnp.ndarray | None = None,
    block: int = 16,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Block-adaptive GSC (block-LMS): one weight update per `block` frames.

    Throughput path — turns the per-frame recurrence into batched matmuls
    with a T/block-length scan.  Converges to the same solution as `gsc_nlms`
    with an effective step ≈ mu (gradient averaged over the block).
    """
    X_tkn = jnp.transpose(X, (1, 2, 0))
    return _gsc_block_impl(
        X_tkn, wq, B, jnp.float32(mu), jnp.float32(eps), jnp.float32(wa_norm_cap), wa0, block=block
    )


def gsc_rls(
    X: jnp.ndarray,
    wq: jnp.ndarray,
    B: jnp.ndarray,
    forget: float = 0.99,
    delta: float = 1e2,
    wa_norm_cap: float = 10.0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """GSC with RLS active weights (reference `SubbandGSCRLS` [K]).

    Per bin k, standard exponentially-weighted RLS on the blocked refs z:
        g = P z / (λ + zᴴ P z);  wa += g · conj(y);  P = (P - g zᴴ P)/λ
    """
    K, N = wq.shape
    import numpy as _np
    wa0 = jnp.asarray(_np.zeros((K, N - 1), _np.complex64))
    P0 = jnp.asarray(_np.tile(_np.eye(N - 1, dtype=_np.complex64) * delta, (K, 1, 1)))
    X_tkn = jnp.transpose(X, (1, 2, 0))
    lam = jnp.float32(forget)

    def step(carry, x):
        wa, P = carry
        yc = jnp.sum(jnp.conj(wq) * x, axis=-1)
        z = jnp.einsum("knm,kn->km", jnp.conj(B), x)
        y = yc - jnp.sum(jnp.conj(wa) * z, axis=-1)
        Pz = jnp.einsum("kmn,kn->km", P, z)
        denom = lam + jnp.real(jnp.sum(jnp.conj(z) * Pz, axis=-1))
        g = Pz / denom[:, None].astype(Pz.dtype)
        wa_new = wa + g * jnp.conj(y)[:, None]
        nrm = jnp.linalg.norm(wa_new, axis=-1, keepdims=True)
        wa_new = wa_new * jnp.minimum(1.0, wa_norm_cap / jnp.maximum(nrm, 1e-30))
        P_new = (P - jnp.einsum("km,kn->kmn", g, jnp.conj(Pz))) / lam
        return (wa_new, P_new), y

    (wa_f, _), Y = jax.lax.scan(step, (wa0, P0), X_tkn)
    return Y, wa_f


@functools.partial(jax.jit, static_argnames=("iters",))
def gsc_maxkurt(
    X: jnp.ndarray,
    wq: jnp.ndarray,
    B: jnp.ndarray,
    mu: float = 0.1,
    iters: int = 50,
    wa_norm_cap: float = 2.0,
    decay: float = 0.1,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Maximum-kurtosis (`SubbandMMI` [K]) GSC — batch adaptation.

    Numerics match `golden.beamforming.gsc_maxkurt`; see there for the
    derivation (normalised, decaying-step kurtosis ascent).  All K bins
    adapt in parallel (the per-bin gradient is two batched reductions over
    frames), and the fixed `iters` gradient
    ascent is a `fori_loop` compiled once.

    X: (N, T, K);  wq: (K, N);  B: (K, N, N-1)  →  (Y (T, K), wa (K, N-1)).
    """
    eps = 1e-12
    Z = jnp.einsum("knm,ntk->kmt", jnp.conj(B), X)    # (K, N-1, T)
    yq = jnp.einsum("kn,ntk->kt", jnp.conj(wq), X)    # (K, T)
    wa0 = jnp.zeros(B.shape[::2], dtype=X.dtype)      # (K, N-1)

    def body(it, wa):
        y = yq - jnp.einsum("km,kmt->kt", jnp.conj(wa), Z)
        ay2 = jnp.abs(y) ** 2
        P = jnp.mean(ay2, axis=1)                     # (K,)
        A = jnp.mean(ay2**2, axis=1)
        e_y2yz = jnp.mean((ay2 * jnp.conj(y))[:, None, :] * Z, axis=2)  # (K, N-1)
        e_yz = jnp.mean(jnp.conj(y)[:, None, :] * Z, axis=2)
        g = (
            -2.0 * e_y2yz / jnp.maximum(P * P, eps)[:, None]
            + (2.0 * A / jnp.maximum(P**3, eps))[:, None] * e_yz
        )
        step = mu / (1.0 + it.astype(jnp.float32) * decay)
        wa = wa + step * g / (jnp.linalg.norm(g, axis=1, keepdims=True) + eps)
        nrm = jnp.linalg.norm(wa, axis=1, keepdims=True)
        return wa * jnp.minimum(1.0, wa_norm_cap / jnp.maximum(nrm, 1e-30))

    wa = jax.lax.fori_loop(0, iters, body, wa0)
    Y = (yq - jnp.einsum("km,kmt->kt", jnp.conj(wa), Z)).T
    return Y, wa
