"""Per-speaker VTLN warp-factor ESTIMATION (SURVEY.md §2.2 feature row:
the reference's VTLN is an estimation procedure — an ML grid search over
warp factors against forced alignments — not just the warp knob
`ops/features.py` exposes; round-4 VERDICT missing #3).

Per speaker: recompute MFCCs at each candidate warp (the mel filterbank
edges move by the Kaldi-style piecewise-linear map, golden/features.py
`vtln_warp_freq`), forced-align the speaker's utterances under the
current AM, and pick the warp maximizing total alignment log-likelihood.
A speaker whose formants sit at s× the training speakers' is recovered at
warp ≈ 1/s (the filter edges scale by 1/warp, so warp=1/s moves them by
s onto the shifted formants).

Design: each warp's feature pass is the batched MFCC matmul chain and
each alignment one batched Viterbi; the grid is a small
Python loop at adaptation time (the reference ran it per speaker too).
"""

from __future__ import annotations

import numpy as np

from dsr.asr import path as apath


DEFAULT_WARPS = tuple(np.round(np.arange(0.85, 1.1501, 0.025), 4))


def estimate_warp(task, params, utts, transcripts,
                  sample_rate: float = 16000.0, warps=None, feats_fn=None):
    """ML grid search for one speaker's warp factor.

    utts: list of waveforms; transcripts: list of word sequences;
    feats_fn(x, warp) → (T, D) features (default: cmn(mfcc(x, sr,
    vtln_warp=warp))).  Returns (best_warp, {warp: total loglik}).
    """
    from dsr.ops import features as jft

    if feats_fn is None:
        def feats_fn(x, w):
            return np.asarray(jft.cmn(jft.mfcc(
                np.asarray(x, np.float32), sample_rate, vtln_warp=float(w))))

    warps = DEFAULT_WARPS if warps is None else warps
    scores: dict = {}
    for a in warps:
        tot = 0.0
        for x, ws in zip(utts, transcripts):
            f = feats_fn(x, a)
            al = apath.force_align(task, params, f, ws)
            tot += al.score
        scores[float(a)] = tot
    best = max(scores, key=scores.get)
    return best, scores
