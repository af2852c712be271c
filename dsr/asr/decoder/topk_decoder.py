"""Batched top-K token-passing WFST decoder (the LVCSR path).

Reference behaviour: token lists + beam & histogram pruning per frame
(SURVEY.md §3.3 HOT LOOP 3).  Realised with fixed shapes:

  - arcs are padded per-state to A_max (CSR → dense (S, A_max) tables)
  - per frame: gather the active tokens' arc rows and score all Kcap·A_max
    candidates at once; token RECOMBINATION (max per destination state) is
    a lexicographic sort by (dst, -score) — the first occurrence of each
    dst in sort order is its best candidate.  The sort-based segmented max
    replaces a dense (S,) score board, so nothing in the frame loop is
    O(S), which also removes the state-count limit on graph size.  Beam
    prune against the frame max, then `top_k` (histogram-prune analogue)
    selects the next Kcap tokens (`recombine_topk`, shared by every
    decoder variant).
  - backpointers: (T, Kcap) winning (state, arc) pairs; traceback matches
    states against each frame's token list on device

Exact when Kcap ≥ #reachable states (tested against the dense decoder);
`parallel/decoder.py` shards the arc tables over the `model` mesh axis and
merges the per-shard survivors with the same `recombine_topk` — the
graph-sharded decode of BASELINE.json config 4.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dsr.asr.fsm.packed import PackedGraph

NEG = -1e30


class TokenGraph(NamedTuple):
    pdf: jnp.ndarray      # (S, A_max) int32
    olabel: jnp.ndarray   # (S, A_max) int32
    weight: jnp.ndarray   # (S, A_max) f32 log-prob (NEG where invalid)
    dst: jnp.ndarray      # (S, A_max) int32
    start: jnp.ndarray
    final_weight: jnp.ndarray  # (S,) f32 log-prob (NEG non-final)
    num_states: int
    a_max: int


def build_token_graph(g: PackedGraph) -> TokenGraph:
    S = g.num_states
    A = len(g.src)
    counts = np.bincount(g.src, minlength=S).astype(np.int64)
    A_max = max(1, int(counts.max()))
    # vectorised per-state slot assignment: stable-sort arcs by src, then
    # slot = rank within the run (LVCSR graphs have 10^5-10^6 arcs)
    order = np.argsort(g.src, kind="stable")
    run_start = np.cumsum(counts) - counts                 # (S,)
    rows = g.src[order].astype(np.int64)
    slots = np.arange(A, dtype=np.int64) - run_start[rows]
    pdf = np.zeros((S, A_max), np.int32)
    ola = np.zeros((S, A_max), np.int32)
    wgt = np.full((S, A_max), NEG, np.float32)
    dst = np.zeros((S, A_max), np.int32)
    pdf[rows, slots] = g.pdf[order]
    ola[rows, slots] = g.olabel[order]
    wgt[rows, slots] = -g.weight[order]
    dst[rows, slots] = g.dst[order]
    fin = np.where(np.isfinite(g.final_weight), -g.final_weight, NEG).astype(np.float32)
    return TokenGraph(
        jnp.asarray(pdf), jnp.asarray(ola), jnp.asarray(wgt), jnp.asarray(dst),
        jnp.asarray(np.int32(g.start)), jnp.asarray(fin),
        S, A_max,
    )


def pack_rows(weight, *ids):
    """Arc rows as ONE int32 plane: `weight` (f32, bit-cast) then each id
    table, side by side — a token's whole arc row is one row gather."""
    return jnp.concatenate(
        [jax.lax.bitcast_convert_type(jnp.asarray(weight, jnp.float32),
                                      jnp.int32)]
        + [jnp.asarray(i, jnp.int32) for i in ids], axis=1)


def unpack_rows(rows, width, n_ids):
    """Inverse of `pack_rows` on gathered rows → (weight, id_0, ...)."""
    w = jax.lax.bitcast_convert_type(rows[:, :width], jnp.float32)
    return (w,) + tuple(rows[:, (j + 1) * width:(j + 2) * width]
                        for j in range(n_ids))


def recombine_topk(cand, fdst, arcs, beam, kcap, nlat=0):
    """One frame's token recombination, beam prune and histogram prune —
    the select stage every decoder (dense, degree-split, graph-sharded)
    shares.

    cand/fdst/arcs: flat (N,) candidate scores, destination states and
    global arc ids, N >= kcap.  A lexicographic sort by (dst, -score, arc)
    puts each destination's best candidate first in its run (the arc id is
    a sort KEY, so exact-score ties go to the smallest arc id); run starts
    are beam-pruned against the frame max and `lax.top_k` keeps kcap.

    Returns (scores (kcap,), dst (kcap,), arc (kcap,)), dead slots
    NEG / 0 / -1.  With nlat > 0 it also returns each survivor's top-nlat
    in-beam incoming arcs (alt_arcs, alt_scores), both (kcap, nlat),
    column 0 the winner itself, dead entries -1 / NEG."""
    with jax.named_scope("recombine_topk"):
        sd, sneg, sa = jax.lax.sort((fdst, -cand, arcs), num_keys=3)
        first = jnp.concatenate([jnp.ones((1,), bool), sd[1:] != sd[:-1]])
        val = jnp.where(first, -sneg, NEG)
        mx = jnp.max(val)
        val = jnp.where(val > mx - beam, val, NEG)
        scores, idx = jax.lax.top_k(val, kcap)
        alive = scores > NEG / 2
        out = (scores, jnp.where(alive, sd[idx], 0),
               jnp.where(alive, sa[idx], -1))
        if not nlat:
            return out
        # the sorted candidates are grouped by dst, best first, and idx[k]
        # is the START of slot k's run — so its top-nlat incoming arcs are
        # positions idx[k]..idx[k]+nlat-1, valid while still inside the run
        ncand = fdst.shape[0]
        pos = idx[:, None] + jnp.arange(nlat)[None, :]       # (kcap, nlat)
        posc = jnp.minimum(pos, ncand - 1)
        v = -sneg[posc]
        ok = ((sd[posc] == sd[idx][:, None]) & (pos < ncand) & alive[:, None]
              & (v > mx - beam))
        return out + (jnp.where(ok, sa[posc], -1), jnp.where(ok, v, NEG))


def _make_step(pdf, weight, dst, *, a_max, kcap, beam, nlat):
    """Build the per-frame token-expansion step shared by the whole-
    utterance scan (`_decode_impl`) and the streaming chunk scan
    (`_decode_chunk_impl`).  Per frame: ONE row gather of the tokens' arc
    rows, a gather of each arc's acoustic score, then `recombine_topk`."""
    packed = pack_rows(weight, pdf, dst)                 # (S, 3·a_max)

    def step(carry, inp):
        states, scores = carry
        t, length, ll = inp
        with jax.named_scope("arc_gather"):
            w, pdfr, cdst = unpack_rows(packed[states], a_max, 2)
        with jax.named_scope("acoustic_lookup"):
            cand = scores[:, None] + w + ll[pdfr]
        # GLOBAL arc id per candidate (arc = state*a_max + slot)
        arc_ids = (states[:, None] * a_max
                   + jax.lax.broadcasted_iota(jnp.int32, (kcap, a_max), 1))
        sel = recombine_topk(cand.reshape(-1), cdst.reshape(-1),
                             arc_ids.reshape(-1), beam, kcap, nlat)
        new_scores, new_states, new_arc = sel[:3]
        alive = new_scores > NEG / 2
        keep = t < length
        states_out = jnp.where(keep, new_states, states)
        scores_out = jnp.where(keep, new_scores, scores)
        bp_arc = jnp.where(keep & alive, new_arc, -1)
        out = (states_out, bp_arc, scores_out)
        if nlat:
            out = out + (jnp.where(keep, sel[3], -1),
                         jnp.where(keep, sel[4], NEG))
        return (states_out, scores_out), out

    return step


def stream_start(graph: TokenGraph, kcap: int = 256):
    """Initial streaming carry: the start-state token."""
    kcap = min(kcap, graph.num_states)
    states0 = jnp.zeros((kcap,), jnp.int32).at[0].set(graph.start)
    scores0 = jnp.full((kcap,), NEG, jnp.float32).at[0].set(0.0)
    return states0, scores0


@functools.partial(jax.jit, static_argnames=("a_max", "kcap", "nlat"))
def _decode_chunk_impl(loglik, length, states0, scores0, pdf, weight, dst, *,
                       a_max, kcap, beam, nlat=0):
    T = loglik.shape[0]
    step = _make_step(pdf, weight, dst, a_max=a_max, kcap=kcap, beam=beam,
                      nlat=nlat)
    ts = jnp.arange(T, dtype=jnp.int32)      # frames ≥ length are padding:
    lens = jnp.full((T,), length, jnp.int32) # carry passes through, arc=-1
    return jax.lax.scan(step, (states0, scores0), (ts, lens, loglik))


# Streaming chunk lengths are bucketed to these values: real front ends
# emit ragged chunk lengths, and every distinct length would otherwise be
# its own compile.  Padded frames are masked by the t<length machinery, so
# results are bit-identical.
CHUNK_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


def _bucket_len(T: int) -> int:
    for b in CHUNK_BUCKETS:
        if T <= b:
            return b
    # beyond the largest bucket: round up to a multiple of it
    top = CHUNK_BUCKETS[-1]
    return ((T + top - 1) // top) * top


def decode_chunk(graph: TokenGraph, loglik: jnp.ndarray, carry,
                 kcap: int = 256, beam: float = 1e9, nlat: int = 0):
    """Streaming decode of one chunk (SURVEY.md §5 long-context: chunked
    scan with carried decoder state).

    carry = (states (kcap,), scores (kcap,)) from `stream_start` or the
    previous chunk.  Returns (new_carry, (tok_states, tok_arcs, tok_scores
    [, alt_arcs, alt_scores])) — accumulate the token arrays and run
    `traceback` at utterance end; the result is IDENTICAL to the
    whole-utterance decode (the scan carry is the decoder's only state).

    Chunks are padded internally to `CHUNK_BUCKETS` lengths and the
    outputs sliced back — callers see exactly T rows.
    """
    kcap = min(kcap, graph.num_states)
    T = loglik.shape[0]
    B = _bucket_len(T)
    if B != T:
        loglik = jnp.pad(loglik, ((0, B - T), (0, 0)))
    new_carry, outs = _decode_chunk_impl(
        loglik, jnp.asarray(T, jnp.int32), carry[0], carry[1], graph.pdf,
        graph.weight, graph.dst, a_max=graph.a_max, kcap=kcap, beam=beam,
        nlat=min(nlat, graph.a_max * kcap),
    )
    if B != T:                   # callers accumulate (states, arcs, scores)
        outs = tuple(o[:T] for o in outs)
    return new_carry, outs


@functools.partial(jax.jit, static_argnames=("a_max",))
def _traceback_impl(tok_states, tok_arcs, states_f, scores_f, final_w, olabel,
                    *, a_max):
    T = tok_states.shape[0]
    total = scores_f + final_w[states_f]
    total = jnp.where(jnp.max(total) > NEG / 2, total, scores_f)
    best_slot = jnp.argmax(total)
    best_state = states_f[best_slot]
    best_score = total[best_slot]

    def back(state, inp):
        sts, arcs = inp
        slot = jnp.argmax(sts == state)
        arc = arcs[slot]
        valid = arc >= 0
        prev = jnp.where(valid, jnp.maximum(arc, 0) // a_max, state)
        olab = jnp.where(valid, olabel.reshape(-1)[jnp.maximum(arc, 0)], 0)
        return prev, olab

    _, olabs = jax.lax.scan(back, best_state, (tok_states, tok_arcs),
                            reverse=True)
    return olabs, best_score


def traceback(graph: TokenGraph, tok_states, tok_arcs, carry):
    """Utterance-final traceback over accumulated (possibly concatenated)
    streaming token arrays → (olabels (T,), score)."""
    states_f, scores_f = carry
    return _traceback_impl(tok_states, tok_arcs, states_f, scores_f,
                           graph.final_weight, graph.olabel, a_max=graph.a_max)


@functools.partial(jax.jit, static_argnames=("a_max", "kcap", "nlat"))
def _decode_impl(loglik, length, pdf, olabel, weight, dst, start, final_w,
                 *, a_max, kcap, beam, nlat=0):
    T = loglik.shape[0]
    states0 = jnp.zeros((kcap,), jnp.int32).at[0].set(start)
    scores0 = jnp.full((kcap,), NEG, jnp.float32).at[0].set(0.0)
    step = _make_step(pdf, weight, dst, a_max=a_max, kcap=kcap, beam=beam,
                      nlat=nlat)
    ts = jnp.arange(T)
    lens = jnp.full((T,), length)
    (states_f, scores_f), outs = jax.lax.scan(
        step, (states0, scores0), (ts, lens, loglik)
    )
    tok_states, tok_arcs, tok_scores = outs[:3]
    total = scores_f + final_w[states_f]
    # final fallback: if no surviving token reaches a final state (e.g. the
    # utterance was cut mid-word), take the best token without the final
    # weight — the reference decoders' GetBestPath behaviour.
    total = jnp.where(jnp.max(total) > NEG / 2, total, scores_f)
    best_slot = jnp.argmax(total)
    best_state = states_f[best_slot]
    best_score = total[best_slot]

    def back(state, inp):
        t, sts, arcs = inp
        slot = jnp.argmax(sts == state)
        arc = arcs[slot]
        valid = (t < length) & (arc >= 0)
        # flat arc id = state*a_max + slot, so src state = arc // a_max
        prev = jnp.where(valid, jnp.maximum(arc, 0) // a_max, state)
        olab = jnp.where(
            valid,
            olabel.reshape(-1)[jnp.maximum(arc, 0)],
            0,
        )
        return prev, olab

    with jax.named_scope("traceback"):
        _, olabs = jax.lax.scan(back, best_state, (ts, tok_states, tok_arcs),
                                reverse=True)
    return (olabs, best_score, tok_states, tok_arcs, tok_scores) + outs[3:]


def decode(graph: TokenGraph, loglik: jnp.ndarray, kcap: int = 256,
           beam: float = 1e9, length=None):
    """loglik: (T, P) → (olabels (T,), score ()).  0-olabels are epsilon."""
    out = decode_with_tokens(graph, loglik, kcap, beam, length)
    return out[0], out[1]


def decode_with_tokens(graph: TokenGraph, loglik: jnp.ndarray, kcap: int = 256,
                       beam: float = 1e9, length=None, nlat: int = 0):
    """Full decode returning the token lattice arrays:
    (olabels, score, tok_states (T,K), tok_arcs (T,K), tok_scores (T,K))
    [+ alt_arcs (T,K,nlat), alt_scores (T,K,nlat) when nlat > 0: the top-N
    incoming arcs per surviving token with their path scores — the TRUE
    lattice links for sum-posterior forward-backward and oracle search
    (reference asr/lattice [K])]."""
    kcap = min(kcap, graph.num_states)
    length = jnp.asarray(loglik.shape[0] if length is None else length,
                         jnp.int32)
    return _decode_impl(
        loglik, length, graph.pdf, graph.olabel, graph.weight, graph.dst,
        graph.start, graph.final_weight, a_max=graph.a_max, kcap=kcap,
        beam=beam, nlat=min(nlat, graph.a_max * kcap),
    )


def decode_batch(graph: TokenGraph, loglik: jnp.ndarray, lengths, kcap: int = 256,
                 beam: float = 1e9):
    """loglik (U, T, P), lengths (U,) → (olabels (U, T), scores (U,))."""
    kcap = min(kcap, graph.num_states)
    f = jax.vmap(
        lambda ll, ln: _decode_impl(
            ll, ln, graph.pdf, graph.olabel, graph.weight, graph.dst,
            graph.start, graph.final_weight, a_max=graph.a_max, kcap=kcap,
            beam=beam,
        )
    )
    out = f(loglik, jnp.asarray(lengths, jnp.int32))
    return out[0], out[1]
