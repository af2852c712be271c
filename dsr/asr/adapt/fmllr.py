"""fMLLR / CMLLR feature-space adaptation (reference `asr/adapt/` [K]).

Estimates an affine feature transform  x' = A x + b  maximising the EM
auxiliary  Q = β·log|A| − ½ Σ_d w_dᵀ G_d w_d − 2 w_dᵀ k_d  (diagonal
covariance), with the standard iterative row update using cofactors:
    w_d ← G_d⁻¹ (k_d + α c_d),  α from the quadratic in the cofactor row.

Statistics (their own accumulation pass — they weight by 1/σ² per dim):
    G_d = Σ_g (1/σ²_{g,d}) Σ_t γ_{t,g} [x_t;1][x_t;1]ᵀ     (D, D+1, D+1)
    k_d = Σ_g (μ_{g,d}/σ²_{g,d}) Σ_t γ_{t,g} [x_t;1]       (D, D+1)
    β   = total occupancy
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST  # offline stats: full-precision einsums

from dsr.asr.am.gmm import GmmParams, component_posteriors


class FmllrStats(NamedTuple):
    G: jnp.ndarray     # (D, D+1, D+1)
    k: jnp.ndarray     # (D, D+1)
    beta: jnp.ndarray  # ()


@jax.jit
def accumulate_fmllr(params: GmmParams, feats: jnp.ndarray, gamma: jnp.ndarray) -> FmllrStats:
    """feats: (..., T, D); gamma: (..., T, S) → FmllrStats (summed)."""
    S, C, D = params.means.shape
    _, post = component_posteriors(params, feats)       # (..., T, S, C)
    w = post * gamma[..., None]                         # (..., T, S, C)
    ones = jnp.ones((*feats.shape[:-1], 1), feats.dtype)
    xe = jnp.concatenate([feats, ones], axis=-1)        # (..., T, D+1)
    inv_v = 1.0 / params.variances                      # (S, C, D)
    # per-frame scalar per (s,c): γ; per-dim weight 1/σ²
    # G_d = Σ_t Σ_sc γ_tsc invv_scd xe_t xe_tᵀ
    occ_t = jnp.einsum("...tsc,scd->...td", w, inv_v, precision=_HI)   # (..., T, D)
    G = jnp.einsum("...td,...ti,...tj->dij", occ_t, xe, xe, precision=_HI)
    mu_iv = params.means * inv_v                        # (S, C, D)
    k_t = jnp.einsum("...tsc,scd->...td", w, mu_iv, precision=_HI)
    k = jnp.einsum("...td,...ti->di", k_t, xe, precision=_HI)
    beta = jnp.sum(w)
    return FmllrStats(G, k, beta)


def estimate_fmllr(stats: FmllrStats, iters: int = 10, reg: float = 1e-4) -> jnp.ndarray:
    """→ Wf (D, D+1) with x' = Wf [x; 1]; initialised at identity."""
    D = stats.k.shape[0]
    G = stats.G + reg * jnp.eye(D + 1)[None]
    k = stats.k
    beta = stats.beta
    W = jnp.concatenate([jnp.eye(D), jnp.zeros((D, 1))], axis=1)

    def row_update(W, d):
        A = W[:, :D]
        # cofactor row d of A: c_d = det(A) · (A⁻ᵀ)_d  (direction only matters)
        detA = jnp.linalg.det(A)
        cof = detA * jnp.linalg.inv(A).T[d]
        c = jnp.concatenate([cof, jnp.zeros(1)])
        Ginv_k = jnp.linalg.solve(G[d], k[d])
        Ginv_c = jnp.linalg.solve(G[d], c)
        a2 = c @ Ginv_c
        a1 = c @ Ginv_k
        # solve β = α (a1 + α a2) → quadratic a2 α² + a1 α − β = 0
        disc = jnp.sqrt(jnp.maximum(a1 * a1 + 4 * a2 * beta, 0.0))
        alpha1 = (-a1 + disc) / (2 * a2)
        alpha2 = (-a1 - disc) / (2 * a2)

        def q_of(alpha):
            wd = Ginv_k + alpha * Ginv_c
            return beta * jnp.log(jnp.abs(wd @ c) + 1e-30) - 0.5 * wd @ G[d] @ wd + wd @ k[d]

        alpha = jnp.where(q_of(alpha1) >= q_of(alpha2), alpha1, alpha2)
        wd = Ginv_k + alpha * Ginv_c
        return W.at[d].set(wd)

    @jax.jit
    def run(W):
        def body(_, W):
            def row(d, W):
                return row_update(W, d)
            return jax.lax.fori_loop(0, D, row, W)
        return jax.lax.fori_loop(0, iters, body, W)

    return run(W)


@jax.jit
def apply_fmllr(feats: jnp.ndarray, Wf: jnp.ndarray) -> jnp.ndarray:
    """x' = A x + b over (..., T, D)."""
    D = feats.shape[-1]
    return feats @ Wf[:, :D].T + Wf[:, D]
