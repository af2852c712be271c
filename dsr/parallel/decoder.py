"""Graph-sharded WFST decoding over the `model` mesh axis (config 4).

The composed HCLG's per-state arc tables are partitioned across devices by
state range; active tokens are replicated over the graph shards; each shard
expands only the tokens whose SOURCE states it owns and recombines its own
candidates with the single-device decoder's `recombine_topk`; the per-frame
exchange is an `all_gather` of each shard's top-Kcap (score, dst, arc)
candidates followed by a replicated merge through `recombine_topk` again —
active-beam state exchanged by collectives inside a batched lax.scan decode
loop (BASELINE.json / SURVEY.md §2.3).  Utterances ride the `data` axis.

Scalability: NOTHING in the frame loop is O(S).  Per frame each shard does
O(Kcap·A_max log) local work plus an O(n_model·Kcap) exchange, so the graph
can exceed one device's memory without the decode loop ever touching a
dense state board.

Exactness: equal to the single-device top-K decode.  The global best
candidate for any destination state is generated on exactly one shard (the
owner of the winning arc's source state), where it outranks the candidates
it beats globally — so it survives that shard's local top-Kcap and the
merged top-Kcap equals the unsharded one.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dsr.asr.decoder.topk_decoder import (NEG, TokenGraph, recombine_topk,
                                          unpack_rows)


def _host_planes(g: TokenGraph, shards: int):
    """(olabel (Sp, A), rows (Sp, 3A) int32 w|pdf|dst, final (Sp,)) as host
    arrays, S padded to a multiple of `shards` — built on the host so that
    each shard is placed straight on its own device."""
    S, A = g.num_states, g.a_max
    pad = -S % shards
    rows = np.concatenate([
        np.asarray(g.weight, np.float32).view(np.int32),
        np.asarray(g.pdf, np.int32), np.asarray(g.dst, np.int32)], axis=1)
    rows = np.pad(rows, ((0, pad), (0, 0)))
    rows[S:, :A] = np.float32(NEG).view(np.int32)
    ola = np.pad(np.asarray(g.olabel, np.int32), ((0, pad), (0, 0)))
    fin = np.pad(np.asarray(g.final_weight, np.float32), (0, pad),
                 constant_values=NEG)
    return ola, rows, fin


def make_sharded_decode(mesh: Mesh, graph: TokenGraph, kcap: int = 256,
                        beam: float = 1e9, return_tokens: bool = False):
    """Build a jitted sharded decode fn: (loglik (U, T, Pdf), lengths (U,))
    → (olabels (U, T), scores (U,)) [+ token arrays if `return_tokens`].

    Arc tables are sharded over `model` by state range; loglik/lengths over
    `data`; the per-frame merge is an all_gather of per-shard top-K
    candidate sets (see module docstring).  Output labels leave the frame
    loop entirely: they are resolved at traceback by owner lookup + pmax.
    """
    n_model = mesh.shape["model"]
    kcap = min(kcap, graph.num_states)
    A = graph.a_max
    start_v = int(graph.start)
    ola, rows, fin = _host_planes(graph, n_model)
    S_shard = rows.shape[0] // n_model

    def decode_shard(ola, rows, fin, loglik, lengths):
        # ola: (S_shard, A); rows: (S_shard, 3A) int32 w|pdf|dst — ONE
        # row gather per frame; fin: (S_shard,); loglik: (U_sh, T, P)
        shard = jax.lax.axis_index("model")
        offset = shard * S_shard

        def fin_of(states):
            """Final weight lookup across shards: owner supplies, pmax merges
            (non-final and non-owned both yield NEG)."""
            local = states - offset
            mine = (local >= 0) & (local < S_shard)
            f = jnp.where(mine, fin[jnp.clip(local, 0, S_shard - 1)], NEG)
            return jax.lax.pmax(f, "model")

        def olab_of(arc):
            """Output label of a GLOBAL arc id across shards: the owner of
            the arc's source state supplies it, pmax merges (labels are
            non-negative; -1 arcs and non-owners yield -1 → max 0)."""
            row = arc // A - offset
            mine = (arc >= 0) & (row >= 0) & (row < S_shard)
            o = jnp.where(
                mine,
                ola[jnp.clip(row, 0, S_shard - 1),
                    jnp.clip(arc % A, 0, A - 1)], -1)
            return jnp.maximum(jax.lax.pmax(o, "model"), 0)

        def one_utt(ll, length):
            T = ll.shape[0]
            states0 = jnp.zeros((kcap,), jnp.int32).at[0].set(jnp.int32(start_v))
            scores0 = jnp.full((kcap,), NEG, jnp.float32).at[0].set(0.0)
            # the carry varies over `data` (it depends on this shard's ll)
            # and is marked varying over `model` too: every shard computes
            # identical merged values (the all_gather makes the merge
            # replicated by construction) but the type system tracks the
            # gather's per-shard provenance; the final pmax re-marks outputs
            # replicated.
            states0 = jax.lax.pcast(states0, ("data", "model"), to="varying")
            scores0 = jax.lax.pcast(scores0, ("data", "model"), to="varying")

            def step(carry, inp):
                states, scores = carry
                t, llt = inp
                # ---- expand MY tokens only (source-state ownership) ------
                local = states - offset
                mine = (local >= 0) & (local < S_shard)
                li = jnp.clip(local, 0, S_shard - 1)
                w, pdfr, dstr = unpack_rows(rows[li], A, 2)
                w = jnp.where(mine[:, None], w, NEG)
                cand = scores[:, None] + w + llt[pdfr]
                arc_ids = (states[:, None] * A
                           + jax.lax.broadcasted_iota(jnp.int32, (kcap, A), 1))
                # ---- local recombine → my top-Kcap -----------------------
                # pre-pruned against the LOCAL frame max with the same
                # beam — safe: local max <= global max, so the local
                # threshold is never tighter than the merge's global one
                loc_v, loc_d, loc_a = recombine_topk(
                    cand.reshape(-1), dstr.reshape(-1), arc_ids.reshape(-1),
                    beam, kcap)
                # ---- exchange: ONE all_gather of a stacked (3, kcap) -----
                # plane (one collective per frame instead of three); the
                # score plane rides bit-cast to int32
                stacked = jnp.stack([
                    jax.lax.bitcast_convert_type(loc_v, jnp.int32),
                    loc_d, loc_a])
                gall = jax.lax.all_gather(stacked, "model", tiled=True,
                                          axis=1)
                gv = jax.lax.bitcast_convert_type(gall[0], jnp.float32)
                # ---- replicated merge: recombine across shards -----------
                new_scores, new_states, m_arc = recombine_topk(
                    gv, gall[1], gall[2], beam, kcap)
                alive = new_scores > NEG / 2
                keep = t < length
                states_o = jnp.where(keep, new_states, states)
                scores_o = jnp.where(keep, new_scores, scores)
                bp_arc = jnp.where(keep & alive, m_arc, -1)
                return (states_o, scores_o), (states_o, bp_arc, scores_o)

            ts = jnp.arange(T)
            (sf, scf), (tok_states, tok_arcs, tok_scores) = jax.lax.scan(
                step, (states0, scores0), (ts, ll)
            )
            total = scf + fin_of(sf)
            # final fallback (matches topk_decoder): best token without the
            # final weight when no token reaches a final state
            total = jnp.where(jnp.max(total) > NEG / 2, total, scf)
            slot = jnp.argmax(total)
            best_state = sf[slot]
            best_score = total[slot]

            def back(state, inp):
                t, sts, arcs = inp
                k = jnp.argmax(sts == state)
                arc = arcs[k]
                valid = (t < length) & (arc >= 0)
                # flat arc id = src*A + slot → src = arc // A (no table)
                prev = jnp.where(valid, jnp.maximum(arc, 0) // A, state)
                olab = jnp.where(valid, olab_of(arc), 0)
                return prev, olab

            _, olabs = jax.lax.scan(
                back, best_state, (ts, tok_states, tok_arcs),
                reverse=True,
            )
            # identical on every model shard already (merge is replicated);
            # the pmax marks them replicated for out_specs inference
            rep = lambda x: jax.lax.pmax(x, "model")
            out = (rep(olabs), rep(best_score))
            if return_tokens:
                out += (rep(tok_states), rep(tok_arcs), rep(tok_scores))
            return out

        return jax.vmap(one_utt)(loglik, lengths)

    nouts = 5 if return_tokens else 2
    fn = shard_map(
        decode_shard,
        mesh=mesh,
        in_specs=(P("model"), P("model"), P("model"), P("data"), P("data")),
        out_specs=tuple(P("data") for _ in range(nouts)),
    )

    # The arc tables are placed SHARDED once at build time, each shard
    # straight from the host onto its own device, and passed as jit
    # ARGUMENTS: closing over them would bake them into the executable as
    # constants — a full unsharded copy that defeats the O(S/n_model)
    # residency at graph sizes beyond one device.
    sharding = NamedSharding(mesh, P("model"))
    g_dev = tuple(
        jax.make_array_from_callback(x.shape, sharding, lambda idx, x=x: x[idx])
        for x in (ola, rows, fin))
    del ola, rows, fin
    jfn = jax.jit(fn)

    def run(loglik, lengths):
        return jfn(*g_dev, jnp.asarray(loglik), jnp.asarray(lengths))

    return run
