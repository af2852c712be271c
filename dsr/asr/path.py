"""Forced-alignment paths (reference `asr/path/` [K]): state-level Viterbi
alignments for training/adaptation, with phone/word segmentations."""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from dsr.asr.am import gmm as jgmm
from dsr.asr.decoder import viterbi as jvit

NEG = -1e30


@dataclass
class Alignment:
    states: np.ndarray        # (T,) global pdf/state ids
    score: float
    segments: list            # [(unit_id, start_frame, end_frame)]


def force_align(task, params: jgmm.GmmParams, feats: np.ndarray, words: list[str]) -> Alignment:
    """Viterbi forced alignment of one utterance against its transcript.

    `task` provides align_graph(words) → (ids, logA, init, final) as in
    smallvocab.SmallVocabTask / phone_task.PhoneTask.
    """
    ids, A, init, final = task.align_graph(words)
    ll = jgmm.loglik(params, jnp.asarray(feats, jnp.float32))
    ll_graph = ll[:, ids]
    path, score = jvit.viterbi(
        ll_graph, jnp.asarray(A, jnp.float32), jnp.asarray(init, jnp.float32),
        jnp.asarray(final, jnp.float32),
    )
    gpath = np.asarray(ids)[np.asarray(path)]
    # segment boundaries: runs of equal graph POSITION (not state id)
    pos = np.asarray(path)
    segs = []
    start = 0
    for t in range(1, len(pos) + 1):
        if t == len(pos) or pos[t] != pos[t - 1]:
            segs.append((int(gpath[start]), start, t))
            start = t
    return Alignment(gpath, float(score), segs)
