"""Dense Viterbi decode / forced alignment.

Numerics match `golden/gmm_hmm.py::viterbi_dense` (reference token-passing
`asr/decoder/` at small scale [K]; the batched WFST decoder handles LVCSR).
Design: one `lax.scan` over frames carrying (S,) scores and emitting
(S,) backpointers; the backtrace is a second (reversed) scan — everything
stays on device and vmaps over an utterance batch (data-parallel decode,
BASELINE.json "utterance batches data-parallel").

Variable lengths: loglik is padded to a common T; frames t ≥ length freeze
the recursion (identity update), so the final scores equal the length-exact
result.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG = -1e30


@jax.jit
def viterbi(loglik, logA, init, final, length=None):
    """loglik: (T, S); logA: (S, S); init/final: (S,).

    → (path (T,) int32, score ()).  If `length` is given (traced ok), frames
    beyond it are frozen and the path is padded with its last state.
    """
    T, S = loglik.shape
    length = T if length is None else length

    def fwd(delta, inp):
        t, ll = inp
        cand = delta[:, None] + logA                     # (S_prev, S)
        psi = jnp.argmax(cand, axis=0).astype(jnp.int32)
        new = jnp.max(cand, axis=0) + ll
        keep = t < length
        delta_out = jnp.where(keep, new, delta)
        return delta_out, psi

    delta0 = init + loglik[0]
    ts = jnp.arange(1, T)
    delta, psis = jax.lax.scan(fwd, delta0, (ts, loglik[1:]))
    last = jnp.argmax(delta + final).astype(jnp.int32)
    score = (delta + final)[last]

    def bwd(state, inp):
        t, psi = inp
        prev = psi[state]
        state_out = jnp.where(t < length, prev, state)
        return state_out, state_out

    _, rev = jax.lax.scan(bwd, last, (ts, psis), reverse=True)
    path = jnp.concatenate([rev, last[None]])
    return path, score


viterbi_batch = jax.jit(jax.vmap(viterbi, in_axes=(0, None, None, None, 0)))


@jax.jit
def forward_backward(loglik, logA, init, final, length=None):
    """Log-domain forward-backward → (gamma (T, S), total loglik ()).

    Matches golden.gmm_hmm.forward_backward; frames ≥ length get γ = 0.
    """
    T, S = loglik.shape
    length = T if length is None else length

    def fstep(alpha, inp):
        t, ll = inp
        new = ll + jax.nn.logsumexp(alpha[:, None] + logA, axis=0)
        alpha_out = jnp.where(t < length, new, alpha)
        return alpha_out, alpha_out

    alpha0 = init + loglik[0]
    ts = jnp.arange(1, T)
    alpha_T, alphas = jax.lax.scan(fstep, alpha0, (ts, loglik[1:]))
    alphas = jnp.concatenate([alpha0[None], alphas])

    def bstep(beta, inp):
        t, ll = inp
        new = jax.nn.logsumexp(logA + (ll + beta)[None, :], axis=1)
        # beta[t] is computed from frame t+1's emission; freeze beyond length
        beta_out = jnp.where(t + 1 < length, new, beta)
        return beta_out, beta_out

    betaT = final
    betas_rev = jax.lax.scan(bstep, betaT, (ts - 1, loglik[1:]), reverse=True)[1]
    betas = jnp.concatenate([betas_rev, betaT[None]])
    total = jax.nn.logsumexp(alpha_T + final)
    gamma = jnp.exp(alphas + betas - total)
    tmask = (jnp.arange(T) < length)[:, None]
    return jnp.where(tmask, gamma, 0.0), total
