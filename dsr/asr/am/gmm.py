"""Diagonal-GMM acoustic model.

Numerics match `golden/gmm_hmm.py::DiagGmm` (reference `asr/gaussian/` +
`asr/distrib*/` [K]).  Design: the mixture log-likelihood is ONE matmul —
HOT LOOP 4 of SURVEY.md §3.3 (per-frame mixture eval) becomes

    ll[t, (s,c)] = [x², x, 1]_t · W_(s,c)

with W rows packed from (-1/(2σ²), μ/σ², bias); (T, 2D+1) @ (2D+1, S·C)
lands in one GEMM, then a logsumexp over the component axis.  Parameters are
a pytree, shardable over the `model` mesh axis when S·C·D exceeds one chip
(BASELINE.json: "acoustic model ... sharded when they exceed one chip").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class GmmParams(NamedTuple):
    means: jnp.ndarray  # (S, C, D)
    variances: jnp.ndarray  # (S, C, D)
    logweights: jnp.ndarray  # (S, C)

    @property
    def num_states(self) -> int:
        return self.means.shape[0]


def from_golden(g) -> GmmParams:
    return GmmParams(
        jnp.asarray(g.means, jnp.float32),
        jnp.asarray(g.vars, jnp.float32),
        jnp.asarray(g.logw, jnp.float32),
    )


def pack_matmul_weights(p: GmmParams) -> tuple[jnp.ndarray, jnp.ndarray]:
    """→ (W (2D+1, S*C), shape info) for the single-matmul loglik."""
    S, C, D = p.means.shape
    inv_v = 1.0 / p.variances
    quad = -0.5 * inv_v                                   # (S, C, D)
    lin = p.means * inv_v
    bias = (
        p.logweights
        - 0.5 * jnp.sum(p.means**2 * inv_v + jnp.log(2 * jnp.pi * p.variances), axis=-1)
    )                                                     # (S, C)
    W = jnp.concatenate(
        [
            quad.reshape(S * C, D).T,                     # x² rows
            lin.reshape(S * C, D).T,                      # x rows
            bias.reshape(1, S * C),                       # 1 row
        ],
        axis=0,
    )
    return W, (S, C, D)


# The mixture product runs at full float32 precision: |loglik| ~ 1e2 is a
# difference of large quadratic terms, and TF32 (the GPU's default for
# float32 matmuls) put 5e-2 absolute error on it against golden/ (measured
# on an H100; 1.5e-4 at HIGHEST).
_HI = jax.lax.Precision.HIGHEST


@jax.jit
def loglik(p: GmmParams, feats: jnp.ndarray) -> jnp.ndarray:
    """(…, T, D) → (…, T, S) mixture log-likelihoods (single matmul)."""
    W, (S, C, D) = pack_matmul_weights(p)
    with jax.named_scope("gmm_loglik"):
        ones = jnp.ones((*feats.shape[:-1], 1), feats.dtype)
        xext = jnp.concatenate([feats**2, feats, ones], axis=-1)  # (…, T, 2D+1)
        ll = jnp.matmul(xext, W, precision=_HI)                   # (…, T, S*C)
        ll = ll.reshape(*feats.shape[:-1], S, C)
        return jax.nn.logsumexp(ll, axis=-1)


@jax.jit
def component_posteriors(p: GmmParams, feats: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """→ (state loglik (…, T, S), per-component posterior (…, T, S, C))."""
    W, (S, C, D) = pack_matmul_weights(p)
    ones = jnp.ones((*feats.shape[:-1], 1), feats.dtype)
    xext = jnp.concatenate([feats**2, feats, ones], axis=-1)
    ll = jnp.matmul(xext, W, precision=_HI).reshape(*feats.shape[:-1], S, C)
    state_ll = jax.nn.logsumexp(ll, axis=-1)
    post = jnp.exp(ll - state_ll[..., None])
    return state_ll, post
