"""Batched WFST Viterbi decoder over packed arc tensors.

HOT LOOP 3 of SURVEY.md §3.3 (per-frame active-arc expansion) becomes a
fixed-shape `lax.scan` over frames:

  dense mode (this module): EVERY arc is expanded every frame —
      cand[a]  = score[src[a]] + weight[a] + loglik[t, pdf[a]]
      score'[s] = max over arcs with dst == s      (segment max)
  i.e. exact Viterbi with no pruning error, as one gather + one segment-max
  per frame.  For graphs up to ~10⁵-10⁶ arcs this saturates the chip and
  needs no top-K machinery; the token-passing top-K path (for pod-scale
  HCLG shards, BASELINE.json config 4) builds on the same arc tensors.

Backpointers are the winning arc id per state per frame ((T, S) int32),
traced back on device by a reversed scan; olabels along the path give the
word sequence.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dsr.asr.fsm.packed import PackedGraph

NEG = -1e30


class DeviceGraph(NamedTuple):
    src: jnp.ndarray
    pdf: jnp.ndarray
    olabel: jnp.ndarray
    weight: jnp.ndarray
    dst: jnp.ndarray
    start: jnp.ndarray        # () int32
    final_weight: jnp.ndarray  # (S,) float32 (NEG-style: -inf → NEG)
    num_states: int


def to_device(g: PackedGraph) -> DeviceGraph:
    fin = np.where(np.isfinite(g.final_weight), -g.final_weight, NEG).astype(np.float32)
    return DeviceGraph(
        jnp.asarray(g.src),
        jnp.asarray(g.pdf),
        jnp.asarray(g.olabel),
        jnp.asarray(-g.weight.astype(np.float32)),  # store as log-prob (max-plus)
        jnp.asarray(g.dst),
        jnp.asarray(np.int32(g.start)),
        jnp.asarray(fin),
        g.num_states,
    )


@functools.partial(jax.jit, static_argnames=("num_states",))
def _decode_impl(loglik, length, src, pdf, olabel, weight, dst, start, final_w, *, num_states):
    T = loglik.shape[0]
    S = num_states

    init = jnp.full((S,), NEG).at[start].set(0.0)

    def step(scores, inp):
        t, ll = inp
        cand = scores[src] + weight + ll[pdf]             # (A,)
        new = jnp.full((S,), NEG).at[dst].max(cand)
        # winning arc per state: max over arcs of (cand, arc_id)
        arc_ids = jnp.arange(cand.shape[0], dtype=jnp.int32)
        is_best = cand >= new[dst] - 1e-6
        best_arc = (
            jnp.full((S,), -1, jnp.int32)
            .at[dst]
            .max(jnp.where(is_best, arc_ids, -1))
        )
        keep = t < length
        scores_out = jnp.where(keep, new, scores)
        return scores_out, jnp.where(keep, best_arc, -1)

    ts = jnp.arange(T)
    scores, bps = jax.lax.scan(step, init, (ts, loglik))
    total = scores + final_w
    best_end = jnp.argmax(total).astype(jnp.int32)
    best_score = total[best_end]

    def back(state, inp):
        t, bp = inp
        arc = bp[state]
        valid = (t < length) & (arc >= 0)
        prev = jnp.where(valid, src[jnp.maximum(arc, 0)], state)
        out = jnp.where(valid, olabel[jnp.maximum(arc, 0)], 0)
        return prev, (out, jnp.where(valid, arc, -1))

    _, (olabs, arcs) = jax.lax.scan(back, best_end, (ts, bps), reverse=True)
    return olabs, arcs, best_score


def decode(
    graph: DeviceGraph, loglik: jnp.ndarray, length=None
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """loglik: (T, num_pdfs) → (olabels (T,), arc path (T,), score ()).

    olabels[t] is the word emitted entering frame t's state (0 = eps);
    read the word sequence with `words_from_olabels`.
    """
    T = loglik.shape[0]
    length = jnp.asarray(T if length is None else length, jnp.int32)
    return _decode_impl(
        loglik, length, graph.src, graph.pdf, graph.olabel, graph.weight,
        graph.dst, graph.start, graph.final_weight, num_states=graph.num_states,
    )


def decode_batch(graph: DeviceGraph, loglik: jnp.ndarray, lengths: jnp.ndarray):
    """Batched decode: loglik (U, T, P), lengths (U,) → stacked results."""
    f = jax.vmap(
        lambda ll, ln: _decode_impl(
            ll, ln, graph.src, graph.pdf, graph.olabel, graph.weight,
            graph.dst, graph.start, graph.final_weight, num_states=graph.num_states,
        )
    )
    return f(loglik, jnp.asarray(lengths, jnp.int32))


def words_from_olabels(olabs: np.ndarray, words_table) -> list[str]:
    return [words_table.name(int(o)) for o in olabs if int(o) != 0]
