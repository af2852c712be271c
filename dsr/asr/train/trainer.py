"""Batched Viterbi-ML trainer for the small-vocab whole-word task.

The reference's training pass (SURVEY.md §3.4) loops utterances in Python
and merges accumulator files across grid jobs.  Here the WHOLE E-step is one
jitted call: utterances are padded to a common (T_max, L_max), alignment
graphs are padded dense matrices, forced alignment is `viterbi_batch` over
the corpus, and accumulation is a batched einsum.  The cross-job file merge
becomes a `psum` (see ml.psum_accum) under data parallelism.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dsr.asr import smallvocab
from dsr.asr.am import gmm as jgmm
from dsr.asr.decoder import viterbi as jvit
from dsr.asr.train import ml

LOG0 = smallvocab.LOG0


def pad_corpus(feats_list: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """→ (feats (U, T_max, D) f32, lengths (U,) i32)."""
    T_max = max(len(f) for f in feats_list)
    D = feats_list[0].shape[1]
    out = np.zeros((len(feats_list), T_max, D), np.float32)
    lens = np.zeros(len(feats_list), np.int32)
    for i, f in enumerate(feats_list):
        out[i, : len(f)] = f
        lens[i] = len(f)
    return out, lens


def pad_align_graphs(task: smallvocab.SmallVocabTask, transcripts: list[list[str]]):
    """Padded per-utterance linear alignment graphs.

    → (ids (U, L_max) i32, logA (U, L_max, L_max) f32, init, final (U, L_max))
    Padding positions are unreachable self-loop states.
    """
    built = [task.align_graph(ws) for ws in transcripts]
    L_max = max(len(b[0]) for b in built)
    U = len(built)
    ids = np.zeros((U, L_max), np.int32)
    A = np.full((U, L_max, L_max), LOG0, np.float32)
    init = np.full((U, L_max), LOG0, np.float32)
    final = np.full((U, L_max), LOG0, np.float32)
    for u, (i_u, A_u, init_u, final_u) in enumerate(built):
        L = len(i_u)
        ids[u, :L] = i_u
        A[u, :L, :L] = A_u
        A[u, np.arange(L, L_max), np.arange(L, L_max)] = 0.0
        init[u, :L] = init_u
        final[u, :L] = final_u
    return ids, A, init, final


_viterbi_graphs = jax.jit(jax.vmap(jvit.viterbi, in_axes=(0, 0, 0, 0, 0)))


@functools.partial(jax.jit, static_argnames=("num_states",))
def _estep(params, feats, lengths, ids, logA, init, final, num_states):
    """One batched Viterbi-EM E-step → (accumulator, total score)."""
    ll = jgmm.loglik(params, feats)                                   # (U, T, S)
    ll_graph = jnp.take_along_axis(ll, ids[:, None, :], axis=2)       # (U, T, L)
    paths, scores = _viterbi_graphs(ll_graph, logA, init, final, lengths)
    gpaths = jnp.take_along_axis(ids, paths, axis=1)                  # (U, T) global states
    mask = jnp.arange(feats.shape[1])[None, :] < lengths[:, None]
    gamma = jax.nn.one_hot(gpaths, num_states, dtype=jnp.float32) * mask[..., None]
    acc = ml.zero_accum(num_states, params.means.shape[1], params.means.shape[2])
    acc = ml.accumulate(params, feats, gamma, acc)
    return acc, jnp.sum(jnp.where(jnp.isfinite(scores), scores, 0.0))


@functools.partial(jax.jit, static_argnames=("num_states",))
def _estep_bw(params, feats, lengths, ids, logA, init, final, num_states):
    """One batched Baum-Welch (soft forward-backward) E-step.

    Same contract as `_estep` but with exact state posteriors γ from
    `ml.forward_backward` instead of a hard Viterbi path — the reference's
    full ML accumulation mode (SURVEY.md §2.2 train: "ML (Baum-Welch)").
    """
    ll = jgmm.loglik(params, feats)                                   # (U, T, S)
    ll_graph = jnp.take_along_axis(ll, ids[:, None, :], axis=2)       # (U, T, L)
    gamma_l, totals = jax.vmap(jvit.forward_backward)(ll_graph, logA, init, final, lengths)
    onehot = jax.nn.one_hot(ids, num_states, dtype=jnp.float32)       # (U, L, S)
    gamma = jnp.einsum("utl,uls->uts", gamma_l, onehot)               # scatter to global states
    acc = ml.zero_accum(num_states, params.means.shape[1], params.means.shape[2])
    acc = ml.accumulate(params, feats, gamma, acc)
    return acc, jnp.sum(jnp.where(jnp.isfinite(totals), totals, 0.0))


def train(
    task: smallvocab.SmallVocabTask,
    feats_list: list[np.ndarray],
    transcripts: list[list[str]],
    num_comp: int = 2,
    iters: int = 4,
    seed: int = 0,
    verbose: bool = False,
    estep: str = "viterbi",
) -> jgmm.GmmParams:
    """Flat-start + `iters` rounds of batched EM (`estep`: viterbi | bw)."""
    from golden import gmm_hmm as ggh

    rng = np.random.default_rng(seed)
    state_seqs = [task.align_graph(ws)[0] for ws in transcripts]
    g0 = ggh.init_gmm_from_feats(feats_list, state_seqs, task.num_states, num_comp, rng)
    params = jgmm.from_golden(g0)
    feats, lengths = pad_corpus(feats_list)
    ids, A, init, final = pad_align_graphs(task, transcripts)
    if estep not in ("viterbi", "bw"):
        raise ValueError(f"estep must be 'viterbi' or 'bw'; got {estep!r}")
    estep_fn = {"viterbi": _estep, "bw": _estep_bw}[estep]
    for it in range(iters):
        acc, total = estep_fn(
            params, feats, lengths, ids, A, init, final, task.num_states
        )
        params = ml.mstep(acc)
        if verbose:
            print(f"iter {it}: total {estep} loglik {float(total):.1f}")
    return params


def decode(
    task: smallvocab.SmallVocabTask,
    params: jgmm.GmmParams,
    feats_list: list[np.ndarray],
) -> list[list[str]]:
    """Batched word-loop Viterbi decode → word sequences."""
    feats, lengths = pad_corpus(feats_list)
    A, init, final = task.decode_graph()
    ll = jgmm.loglik(params, feats)
    paths, _ = jvit.viterbi_batch(
        ll, jnp.asarray(A, jnp.float32), jnp.asarray(init, jnp.float32),
        jnp.asarray(final, jnp.float32), jnp.asarray(lengths),
    )
    paths = np.asarray(paths)
    return [task.path_to_words(paths[u, : lengths[u]]) for u in range(len(feats_list))]
