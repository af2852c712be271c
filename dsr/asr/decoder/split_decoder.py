"""Degree-split top-K decoder — the candidate-pool structural lever.

The dense TokenGraph pads every state's arc row to A_max (47 on the
532k-state monophone LVCSR HCLG, 263 on the tied-triphone one) while the
MEAN out-degree is 2.44 (3.95): most of the dense frame pool is padding
that the row gather, the acoustic lookup and the select stage all pay
for.  This variant packs arcs two-tier:

  - a (S, a0) MAIN table: every state's first a0 arcs;
  - an OVERFLOW table of a0-arc GROUP rows for the high-degree states;
    a token on such a state expands its extra groups through a fixed
    per-frame budget of EG group slots, assigned by prefix sum over the
    active tokens (ragged → dense with one searchsorted).

Candidates per frame: (K + EG)·a0 — 2304 at K=256, EG=896, a0=2 against
the dense table's 12032 on the monophone graph.  `bench.py` and
`chip_smoke.py` run a0=2 / eg=896 (monophone) and a0=4 / eg=640 / kcap=512
(triphone).

Exactness: identical to the dense decoder whenever the frame's overflow
demand fits the EG budget; that is certified per frame (`overflow`
output).  Budget overruns drop the HIGHEST-indexed tokens' extra groups
first (tokens are score-sorted from the previous frame's selection, so
the dropped extras belong to the weakest tokens).

Arc ids are uniform row*a0+slot over [main rows | overflow rows], so the
traceback needs only a src_of_row table; lattice (nlat) decoding stays
on the dense path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dsr.asr.decoder.topk_decoder import (NEG, pack_rows, recombine_topk,
                                          unpack_rows)
from dsr.asr.fsm.packed import PackedGraph

A0 = 8


class SplitTokenGraph(NamedTuple):
    packed: jnp.ndarray      # (S, 3*a0+2) int32: w|pdf|dst|ov_base|ov_cnt
    ov_packed: jnp.ndarray   # (G, 3*a0) int32: w|pdf|dst per overflow group
    olabel: jnp.ndarray      # ((S+G)*A0,) int32 by uniform arc id
    src_of_row: jnp.ndarray  # (S+G,) int32 source state per table row
    start: jnp.ndarray
    final_weight: jnp.ndarray
    num_states: int
    num_groups: int
    a0: int = A0


def build_split_graph(g: PackedGraph, a0: int = A0) -> SplitTokenGraph:
    """Pack two-tier with a MAIN width of `a0` (default 8).  Smaller a0
    shrinks the kcap*a0 main pool on low-mean-degree graphs (triphone
    mean deg 3.9) at the price of more overflow-group traffic
    (tools/exp_tri_decode.py sweeps it).  Rows are int32 planes with the
    weights bit-cast (`topk_decoder.pack_rows`), so ids are exact at any
    graph size."""
    S = g.num_states
    A = len(g.src)
    counts = np.bincount(g.src, minlength=S).astype(np.int64)
    order = np.argsort(g.src, kind="stable")
    run_start = np.cumsum(counts) - counts
    rows = g.src[order].astype(np.int64)
    slots = np.arange(A, dtype=np.int64) - run_start[rows]

    main = slots < a0
    w_m = np.full((S, a0), NEG, np.float32)
    p_m = np.zeros((S, a0), np.int32)
    d_m = np.zeros((S, a0), np.int32)
    o_m = np.zeros((S, a0), np.int32)
    w_m[rows[main], slots[main]] = -g.weight[order][main]
    p_m[rows[main], slots[main]] = g.pdf[order][main]
    d_m[rows[main], slots[main]] = g.dst[order][main]
    o_m[rows[main], slots[main]] = g.olabel[order][main]

    # overflow groups: ceil((deg - a0)/a0) per high-degree state, packed
    extra = np.maximum(counts - a0, 0)
    ngrp = -(-extra // a0)
    ov_base = np.zeros(S, np.int64)
    ov_base[1:] = np.cumsum(ngrp)[:-1]
    G = int(ngrp.sum())
    w_o = np.full((max(G, 1), a0), NEG, np.float32)
    p_o = np.zeros((max(G, 1), a0), np.int32)
    d_o = np.zeros((max(G, 1), a0), np.int32)
    o_o = np.zeros((max(G, 1), a0), np.int32)
    ext = ~main
    es = slots[ext] - a0
    erow = ov_base[rows[ext]] + es // a0
    eslot = es % a0
    w_o[erow, eslot] = -g.weight[order][ext]
    p_o[erow, eslot] = g.pdf[order][ext]
    d_o[erow, eslot] = g.dst[order][ext]
    o_o[erow, eslot] = g.olabel[order][ext]

    grp_state = np.repeat(np.arange(S, dtype=np.int64), ngrp)
    src_of_row = np.concatenate([np.arange(S, dtype=np.int64),
                                 grp_state]).astype(np.int32)
    olabel = np.concatenate([o_m, o_o[:G] if G else o_o[:0]],
                            axis=0).reshape(-1).astype(np.int32)
    packed = pack_rows(w_m, p_m, d_m, ov_base[:, None], ngrp[:, None])
    ov_packed = pack_rows(w_o, p_o, d_o)
    fin = np.where(np.isfinite(g.final_weight), -g.final_weight,
                   NEG).astype(np.float32)
    return SplitTokenGraph(
        packed, ov_packed, jnp.asarray(olabel), jnp.asarray(src_of_row),
        jnp.asarray(np.int32(g.start)), jnp.asarray(fin), S, G, a0)


@functools.partial(jax.jit, static_argnames=("num_states", "num_groups",
                                             "kcap", "eg", "a0"))
def _decode_split_impl(loglik, length, packed, ov_packed, src_of_row,
                       final_w, start, *, num_states, num_groups, kcap,
                       beam, eg, a0=A0):
    T = loglik.shape[0]
    S = num_states
    iota_e = jnp.arange(eg, dtype=jnp.int32)

    def step(carry, inp):
        states, scores = carry
        t, ll = inp
        with jax.named_scope("arc_gather"):
            rows = packed[states]                   # (K, 3*a0+2) ONE gather
            w_m, pdf_m, dst_m = unpack_rows(rows, a0, 2)
            ovb = rows[:, 3 * a0]
            ovc = rows[:, 3 * a0 + 1]

            # ---- ragged overflow groups → EG dense slots ----------------
            ovc_live = jnp.where(scores > NEG / 2, ovc, 0)
            pref = jnp.cumsum(ovc_live) - ovc_live          # exclusive
            demand = pref[-1] + ovc_live[-1]
            overflow = demand > eg
            # slot e belongs to token t_e = #{k: pref_k <= e} - 1; one
            # (EG, K) compare-and-count fusion — the default binary-search
            # method lowers to a while loop of small kernels per frame
            t_e = jnp.searchsorted(pref, iota_e, side="right",
                                   method="compare_all") - 1
            tk_e = jnp.maximum(t_e, 0)
            j_e = iota_e - pref[tk_e]
            valid_e = (t_e >= 0) & (j_e < ovc_live[tk_e])
            grow = jnp.clip(ovb[tk_e] + j_e, 0, max(num_groups - 1, 0))
            w_e, pdf_e, dst_e = unpack_rows(ov_packed[grow], a0, 2)
            w_e = jnp.where(valid_e[:, None], w_e, NEG)

        # ---- unified (K+EG, a0) candidate block -------------------------
        w_all = jnp.concatenate([w_m, w_e], axis=0)
        pdf_all = jnp.concatenate([pdf_m, pdf_e], axis=0)
        dst_all = jnp.concatenate([dst_m, dst_e], axis=0)
        base = jnp.concatenate([scores, scores[tk_e]], axis=0)
        row_id = jnp.concatenate([states, S + grow], axis=0)
        with jax.named_scope("acoustic_lookup"):
            cand = base[:, None] + w_all + ll[pdf_all]
        arc_ids = (row_id[:, None] * a0 + jnp.arange(a0)[None, :])
        new_scores, new_states, new_arc = recombine_topk(
            cand.reshape(-1), dst_all.reshape(-1), arc_ids.reshape(-1),
            beam, kcap)
        alive = new_scores > NEG / 2
        keep = t < length
        states_o = jnp.where(keep, new_states, states)
        scores_o = jnp.where(keep, new_scores, scores)
        bp = jnp.where(keep & alive, new_arc, -1)
        return (states_o, scores_o), (states_o, bp, overflow & keep)

    states0 = jnp.zeros((kcap,), jnp.int32).at[0].set(start)
    scores0 = jnp.full((kcap,), NEG, jnp.float32).at[0].set(0.0)
    (sf, scf), (tok_states, tok_arcs, overflows) = jax.lax.scan(
        step, (states0, scores0), (jnp.arange(T), loglik))
    total = scf + final_w[sf]
    total = jnp.where(jnp.max(total) > NEG / 2, total, scf)
    slot = jnp.argmax(total)
    best_state = sf[slot]
    best_score = total[slot]

    def back(state, inp):
        t, sts, arcs = inp
        k = jnp.argmax(sts == state)
        arc = arcs[k]
        valid = (t < length) & (arc >= 0)
        prev = jnp.where(valid, src_of_row[jnp.maximum(arc, 0) // a0], state)
        return prev, (jnp.maximum(arc, 0), valid)

    with jax.named_scope("traceback"):
        _, (arcs_bt, valid_bt) = jax.lax.scan(
            back, best_state, (jnp.arange(T), tok_states, tok_arcs),
            reverse=True)
    return arcs_bt, valid_bt, best_score, jnp.sum(overflows)


def decode_split(graph: SplitTokenGraph, loglik, kcap: int = 256,
                 beam: float = 1e9, length=None, eg: int = 256):
    """Degree-split decode of one utterance: loglik (T, P) →
    (olabels (T,), score, overflow_frames).  Batch with jax.vmap."""
    T = loglik.shape[0]
    kcap = min(kcap, graph.num_states)
    ln = jnp.asarray(T if length is None else length, jnp.int32)
    arcs, valid, score, ovf = _decode_split_impl(
        loglik, ln, graph.packed, graph.ov_packed, graph.src_of_row,
        graph.final_weight, graph.start, num_states=graph.num_states,
        num_groups=graph.num_groups, kcap=kcap, beam=beam, eg=eg,
        a0=graph.a0)
    olabs = jnp.where(valid, graph.olabel[arcs], 0)
    return olabs, score, ovf


def decode_batch_split(graph: SplitTokenGraph, loglik, lengths,
                       kcap: int = 256, beam: float = 1e9, eg: int = 256):
    """Batched degree-split decode: loglik (U, T, P), lengths (U,) →
    (olabels (U, T), scores (U,), overflow_frames (U,))."""
    f = jax.vmap(lambda ll, ln: decode_split(
        graph, ll, kcap=kcap, beam=beam, length=ln, eg=eg))
    return f(loglik, jnp.asarray(lengths, jnp.int32))
