"""Golden GMM-HMM acoustic model + dense Viterbi decode + Viterbi-EM training.

Capability parity target: reference `asr/gaussian/` (diagonal-covariance
Gaussian codebooks), `asr/distrib*/` (mixture distributions), `asr/decoder/`
(token-passing Viterbi), `asr/train/` (ML estimation) at small-vocabulary
scale (SURVEY.md §2.2, §3.3/3.4 [K]; BASELINE.json config 1).  Large-vocab
WFST decoding lives in the fsm/decoder modules.

Model: per-state diagonal GMMs; utterance/word HMMs are left-to-right with
self-loops; a decode "graph" here is a dense (S, S) log-transition matrix —
exact and small, the golden oracle for the batched decoder.
"""

from __future__ import annotations

import numpy as np

LOG0 = -1e30


def logsumexp(a, axis=None):
    m = np.max(a, axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(a - m), axis=axis, keepdims=True))
    return np.squeeze(out, axis=axis) if axis is not None else out.reshape(())


class DiagGmm:
    """Per-state diagonal-covariance GMM set.  means/vars: (S, C, D)."""

    def __init__(self, means, variances, logweights):
        self.means = np.asarray(means, np.float64)
        self.vars = np.asarray(variances, np.float64)
        self.logw = np.asarray(logweights, np.float64)

    @property
    def num_states(self):
        return self.means.shape[0]

    def loglik(self, feats: np.ndarray) -> np.ndarray:
        """(T, D) → (T, S) log p(x_t | state)."""
        T, D = feats.shape
        S, C, _ = self.means.shape
        x = feats[:, None, None, :]  # (T, 1, 1, D)
        d = x - self.means[None]  # (T, S, C, D)
        ll = -0.5 * np.sum(d * d / self.vars[None] + np.log(2 * np.pi * self.vars[None]), axis=-1)
        return logsumexp(ll + self.logw[None], axis=2)


def linear_hmm(num_states: int, self_lp: float = np.log(0.6)) -> np.ndarray:
    """Left-to-right HMM log-transition matrix (S+1 incl. exit column).

    → (S, S+1): self-loop + advance (last state advances to virtual exit).
    """
    adv = np.log1p(-np.exp(self_lp))
    A = np.full((num_states, num_states + 1), LOG0)
    for s in range(num_states):
        A[s, s] = self_lp
        A[s, s + 1] = adv
    return A


def viterbi_dense(loglik: np.ndarray, logA: np.ndarray, init: np.ndarray, final: np.ndarray):
    """Exact dense Viterbi.  loglik: (T, S); logA: (S, S); init/final: (S,).

    Returns (best_path (T,), best_score).
    """
    T, S = loglik.shape
    delta = init + loglik[0]
    psi = np.zeros((T, S), np.int32)
    for t in range(1, T):
        cand = delta[:, None] + logA  # (S_prev, S)
        psi[t] = np.argmax(cand, axis=0)
        delta = cand[psi[t], np.arange(S)] + loglik[t]
    last = int(np.argmax(delta + final))
    score = float(delta[last] + final[last])
    path = np.empty(T, np.int32)
    path[-1] = last
    for t in range(T - 1, 0, -1):
        path[t - 1] = psi[t, path[t]]
    return path, score


def forward_backward(loglik: np.ndarray, logA: np.ndarray, init: np.ndarray, final: np.ndarray):
    """Log-domain forward-backward.  → (gamma (T, S), total_loglik)."""
    T, S = loglik.shape
    alpha = np.empty((T, S))
    beta = np.empty((T, S))
    alpha[0] = init + loglik[0]
    for t in range(1, T):
        alpha[t] = loglik[t] + logsumexp(alpha[t - 1][:, None] + logA, axis=0)
    beta[-1] = final
    for t in range(T - 2, -1, -1):
        beta[t] = logsumexp(logA + (loglik[t + 1] + beta[t + 1])[None, :], axis=1)
    total = logsumexp(alpha[-1] + final)
    gamma = alpha + beta - total
    return np.exp(gamma), float(total)


# ---------------------------------------------------------------- training


class GmmAccumulator:
    """Sufficient statistics: occupancy, sum x, sum x² per (state, comp)."""

    def __init__(self, S, C, D):
        self.occ = np.zeros((S, C))
        self.sx = np.zeros((S, C, D))
        self.sxx = np.zeros((S, C, D))

    def add(self, other):
        self.occ += other.occ
        self.sx += other.sx
        self.sxx += other.sxx
        return self


def accumulate(gmm: DiagGmm, feats: np.ndarray, gamma_states: np.ndarray, acc: GmmAccumulator):
    """E-step: state occupancies gamma (T, S) → per-component stats."""
    T, D = feats.shape
    S, C, _ = gmm.means.shape
    x = feats[:, None, None, :]
    d = x - gmm.means[None]
    comp_ll = -0.5 * np.sum(d * d / gmm.vars[None] + np.log(2 * np.pi * gmm.vars[None]), axis=-1)
    comp_ll = comp_ll + gmm.logw[None]  # (T, S, C)
    comp_post = np.exp(comp_ll - logsumexp(comp_ll, axis=2)[:, :, None])
    w = comp_post * gamma_states[:, :, None]  # (T, S, C)
    acc.occ += w.sum(0)
    acc.sx += np.einsum("tsc,td->scd", w, feats)
    acc.sxx += np.einsum("tsc,td->scd", w, feats**2)


def mstep(acc: GmmAccumulator, var_floor: float = 1e-3, min_occ: float = 1e-2) -> DiagGmm:
    occ = np.maximum(acc.occ, min_occ)
    means = acc.sx / occ[:, :, None]
    variances = np.maximum(acc.sxx / occ[:, :, None] - means**2, var_floor)
    w = np.maximum(acc.occ, 1e-8)
    logw = np.log(w / w.sum(axis=1, keepdims=True))
    return DiagGmm(means, variances, logw)


def init_gmm_from_feats(feats_list, state_splits, num_states, num_comp, rng):
    """Flat-start: uniformly segment each utterance's frames over its states,
    then per-state k-means-ish init of components."""
    D = feats_list[0].shape[1]
    buckets = [[] for _ in range(num_states)]
    for feats, states in zip(feats_list, state_splits):
        T = len(feats)
        n = len(states)
        bounds = np.linspace(0, T, n + 1).astype(int)
        for i, s in enumerate(states):
            buckets[s].append(feats[bounds[i] : bounds[i + 1]])
    means = np.zeros((num_states, num_comp, D))
    variances = np.ones((num_states, num_comp, D))
    logw = np.full((num_states, num_comp), -np.log(num_comp))
    for s in range(num_states):
        if buckets[s]:
            xs = np.concatenate(buckets[s], axis=0)
        else:
            xs = rng.standard_normal((num_comp, D))
        mu, var = xs.mean(0), xs.var(0) + 1e-2
        for c in range(num_comp):
            pick = xs[rng.integers(0, len(xs))] if len(xs) else mu
            means[s, c] = 0.5 * (mu + pick)
            variances[s, c] = np.maximum(var, 1e-2)
    return DiagGmm(means, variances, logw)
