"""Reference CTC prefix beam search (NumPy, from the math) — the
conventions oracle for dsr.models.conformer.beam_ctc_decode.

Implements the SAME algorithm contract as the JAX scan: fixed beam
width, per-beam stay mass (blank + repeat merged; a repeated label only
crosses a blank), extensions from the full mass except blocked repeats,
optional shallow fusion `lm_weight·lm[last, c] + bonus`, NO cross-parent
prefix merging, ties broken by total score then (stay before extend,
smaller label first) to mirror the vectorised top-k's row-major
argpartition order."""

from __future__ import annotations

import numpy as np

NEG = -1e30


def _lse(a, b):
    m = max(a, b)
    if m <= NEG / 2:
        return NEG
    return m + np.log(np.exp(a - m) + np.exp(b - m))


def beam_ctc_reference(logits, beam=8, lm=None, lm_weight=0.0, bonus=0.0,
                       max_len=64):
    """logits (T, V+1), blank id 0 → (ids list, total_logprob)."""
    logp = logits - np.logaddexp.reduce(logits, axis=-1, keepdims=True)
    T, V1 = logp.shape
    if lm is None:
        lm = np.zeros((V1, V1), np.float64)
    # beams: list of (prefix tuple, last, pb, pnb)
    beams = [((), 0, 0.0, NEG)] + [((), 0, NEG, NEG)] * (beam - 1)
    for t in range(T):
        lp = logp[t]
        cands = []  # (score, order_key, prefix, last, pb, pnb)
        for bi, (pre, last, pb, pnb) in enumerate(beams):
            tot = _lse(pb, pnb)
            pb_stay = tot + lp[0]
            pnb_stay = pnb + lp[last] if pnb > NEG / 2 else NEG
            cands.append((_lse(pb_stay, pnb_stay), (bi, 0), pre, last,
                          pb_stay, pnb_stay))
            for c in range(1, V1):
                base = pb if c == last else tot
                if len(pre) >= max_len:
                    base = NEG
                sc = base + lp[c] + lm_weight * lm[last, c] + bonus
                cands.append((sc, (bi, c), pre + (c,), c, NEG, sc))
        cands.sort(key=lambda x: (-x[0], x[1]))
        beams = [(p, l, pb, pnb) for _, _, p, l, pb, pnb in cands[:beam]]
    best = max(beams, key=lambda b: _lse(b[2], b[3]))
    return list(best[0]), _lse(best[2], best[3])
