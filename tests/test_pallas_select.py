"""Parity tests for the decoders' shared recombination/prune stage
(`topk_decoder.recombine_topk`) against a NumPy transcription of its
semantics: lexicographic (dst, -score, arc) recombination, beam against
the frame max, exact top-kcap."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dsr.asr.decoder import topk_decoder as tk

NEG = tk.NEG


def select(cand, fdst, arcs, beam, kcap, nlat=0):
    return jax.jit(tk.recombine_topk, static_argnames=("kcap", "nlat"))(
        jnp.asarray(cand), jnp.asarray(fdst), jnp.asarray(arcs),
        jnp.float32(beam), kcap=kcap, nlat=nlat)


def ref_select(cand, fdst, arcs, beam, kcap):
    """The XLA path: lexicographic sort-recombine, beam, exact top-k.
    Returns (scores, dst, arc) of the kept tokens, dead slots NEG."""
    order = np.lexsort((arcs, -cand, fdst))
    sd, sv, sa = fdst[order], cand[order], arcs[order]
    first = np.r_[True, sd[1:] != sd[:-1]]
    val = np.where(first, sv, NEG)
    mx = val.max()
    val = np.where(val > mx - beam, val, NEG)
    top = np.argsort(-val, kind="stable")[:kcap]
    return val[top], sd[top], sa[top]


def pairs(scores, dst, arc):
    alive = scores > NEG / 2
    return sorted(zip(np.asarray(dst)[alive].tolist(),
                      np.round(np.asarray(scores)[alive], 4).tolist(),
                      np.asarray(arc)[alive].tolist()))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n,kcap,ndst,beam", [
    (2000, 128, 400, 1e9),     # heavy dst duplication
    (2000, 128, 400, 2.0),     # beam actually prunes
    (12032, 256, 5000, 1e9),   # the LVCSR bench shape
    (600, 128, 10000, 1e9),    # fewer candidates than kcap survivors
    (512, 256, 300, 1e9),      # sharded cross-shard MERGE shape:
                               # n_model*kcap candidates
])
def test_kernel_matches_sort_path(seed, n, kcap, ndst, beam):
    rng = np.random.default_rng(seed)
    cand = rng.standard_normal(n).astype(np.float32) * 5
    fdst = rng.integers(0, ndst, n).astype(np.int32)
    arcs = np.arange(n, dtype=np.int32)
    rs, rd, ra = ref_select(cand, fdst, arcs, beam, kcap)
    ks, kd, ka = select(cand, fdst, arcs, beam, kcap)
    assert pairs(ks, kd, ka) == pairs(rs, rd, ra)


@pytest.mark.parametrize("n,kcap,ndst,beam", [
    (24064, 512, 20000, 1e9),   # monophone kcap=512 (past the old 16384 gate)
    (24064, 512, 20000, 6.0),   # …with a binding beam
    (40000, 256, 30000, 1e9),   # R=512: four presort sub-blocks
])
def test_kernel_big_pool_matches_sort_path(n, kcap, ndst, beam):
    """Big candidate pools: monophone kcap=512 and a 40k-candidate frame."""
    rng = np.random.default_rng(11)
    cand = rng.standard_normal(n).astype(np.float32) * 5
    fdst = rng.integers(0, ndst, n).astype(np.int32)
    arcs = np.arange(n, dtype=np.int32)
    rs, rd, ra = ref_select(cand, fdst, arcs, beam, kcap)
    ks, kd, ka = select(cand, fdst, arcs, beam, kcap)
    assert pairs(ks, kd, ka) == pairs(rs, rd, ra)


def test_per_utterance_beams_batch():
    """vmapped beams must apply each utterance's OWN beam."""
    rng = np.random.default_rng(5)
    U, n, kcap = 3, 2048, 128
    cand = rng.standard_normal((U, n)).astype(np.float32) * 5
    fdst = rng.integers(0, 500, (U, n)).astype(np.int32)
    arcs = np.broadcast_to(np.arange(n, dtype=np.int32), (U, n)).copy()
    beams = np.asarray([1e9, 3.0, 0.5], np.float32)
    ks, kd, ka = jax.jit(jax.vmap(
        lambda c, f, a, b: tk.recombine_topk(c, f, a, b, kcap=kcap)
    ))(jnp.asarray(cand), jnp.asarray(fdst), jnp.asarray(arcs),
       jnp.asarray(beams))
    for u in range(U):
        rs, rd, ra = ref_select(cand[u], fdst[u], arcs[u], beams[u], kcap)
        assert pairs(ks[u], kd[u], ka[u]) == pairs(rs, rd, ra)


def test_spill_flags_adversarial_lane():
    """The 24 largest scores at a stride of 128 (one column of a 128-wide
    layout), all distinct destinations: every one must survive, exactly
    as the reference keeps them."""
    n, kcap = 4096, 128
    rng = np.random.default_rng(7)
    cand = rng.standard_normal(n).astype(np.float32)
    # lane 5 (flat index ≡ 5 mod 128) gets the 24 largest scores
    hot = 5 + 128 * np.arange(24)
    cand[hot] = 100.0 + np.arange(24)
    fdst = np.arange(n, dtype=np.int32)     # no dups: all are winners
    arcs = np.arange(n, dtype=np.int32)
    ks, kd, ka = select(cand, fdst, arcs, 1e9, kcap)
    assert pairs(ks, kd, ka) == pairs(*ref_select(cand, fdst, arcs, 1e9, kcap))
    assert set(hot.tolist()) <= set(np.asarray(ka).tolist())


def test_spill_flags_adversarial_lane_sub_block():
    """Same, with the hot column starting 16384 candidates into a
    24064-candidate frame."""
    n, kcap = 24064, 128
    rng = np.random.default_rng(9)
    cand = rng.standard_normal(n).astype(np.float32)
    base = 128 * 128      # flat start of sub-block 1
    hot = base + 7 + 128 * np.arange(24)
    cand[hot] = 100.0 + np.arange(24)
    fdst = np.arange(n, dtype=np.int32)
    arcs = np.arange(n, dtype=np.int32)
    ks, kd, ka = select(cand, fdst, arcs, 1e9, kcap)
    assert pairs(ks, kd, ka) == pairs(*ref_select(cand, fdst, arcs, 1e9, kcap))
    assert set(hot.tolist()) <= set(np.asarray(ka).tolist())


def ref_select_lat(cand, fdst, arcs, beam, kcap, nlat):
    """The XLA lattice path: winners as ref_select, plus each winner's
    top-nlat in-beam run members (column 0 = the winner itself)."""
    n = len(cand)
    order = np.lexsort((arcs, -cand, fdst))
    sd, sv, sa = fdst[order], cand[order], arcs[order]
    first = np.r_[True, sd[1:] != sd[:-1]]
    val = np.where(first, sv, NEG)
    mx = val.max()
    val = np.where(val > mx - beam, val, NEG)
    top = np.argsort(-val, kind="stable")[:kcap]
    alt_a = np.full((kcap, nlat), -1, np.int64)
    alt_s = np.full((kcap, nlat), NEG, np.float64)
    for k in range(kcap):
        if val[top[k]] <= NEG / 2:
            continue
        i = top[k]
        for j in range(nlat):
            p = i + j
            if p >= n or sd[p] != sd[i]:
                break
            if sv[p] > mx - beam:
                alt_a[k, j] = sa[p]
                alt_s[k, j] = sv[p]
    return val[top], sd[top], alt_a, alt_s


def lat_by_dst(dst, w, alt_a, alt_s):
    """winner dst → ordered valid (score, arc) run members."""
    out = {}
    for k in range(len(dst)):
        if w[k] <= NEG / 2:
            continue
        mem = [(round(float(alt_s[k, j]), 4), int(alt_a[k, j]))
               for j in range(alt_s.shape[1]) if alt_a[k, j] >= 0]
        out[int(dst[k])] = mem
    return out


@pytest.mark.parametrize("beam", [1e9, 3.0])
def test_lattice_mode_matches_sort_path(beam):
    """nlat>0: the (kcap, nlat) alternate-arc layout equals the
    reference's, and the winners equal the 1-best call's."""
    rng = np.random.default_rng(21)
    n, kcap, nlat = 2048, 128, 4
    cand = rng.standard_normal(n).astype(np.float32) * 4
    fdst = rng.integers(0, 300, n).astype(np.int32)   # ~7 cands per dst
    arcs = np.arange(n, dtype=np.int32)
    ks, kd, ka, aa, asc = select(cand, fdst, arcs, beam, kcap, nlat)
    rw, rd, raa, ras = ref_select_lat(cand, fdst, arcs, beam, kcap, nlat)
    got = lat_by_dst(np.asarray(kd), np.asarray(ks), np.asarray(aa),
                     np.asarray(asc))
    want = lat_by_dst(rd, rw, raa, ras)
    assert got == want
    # winner column == 1-best output of the same call shape
    ks1, kd1, ka1 = select(cand, fdst, arcs, beam, kcap)
    assert pairs(ks, kd, np.asarray(aa)[:, 0]) == pairs(ks1, kd1, ka1)


def test_lattice_mode_conservative_spill():
    """Lattice mode at the dense monophone bench pool (12032 candidates,
    kcap=256, nlat=4) equals the reference exactly."""
    rng = np.random.default_rng(23)
    n, kcap, nlat = 12032, 256, 4
    cand = rng.standard_normal(n).astype(np.float32)
    fdst = rng.integers(0, 5000, n).astype(np.int32)
    arcs = np.arange(n, dtype=np.int32)
    ks, kd, ka, aa, asc = select(cand, fdst, arcs, 1e9, kcap, nlat)
    rw, rd, raa, ras = ref_select_lat(cand, fdst, arcs, 1e9, kcap, nlat)
    assert lat_by_dst(np.asarray(kd), np.asarray(ks), np.asarray(aa),
                      np.asarray(asc)) == lat_by_dst(rd, rw, raa, ras)


def test_lattice_mode_batched():
    rng = np.random.default_rng(29)
    U, n, kcap, nlat = 3, 2048, 128, 2
    cand = rng.standard_normal((U, n)).astype(np.float32) * 4
    fdst = rng.integers(0, 300, (U, n)).astype(np.int32)
    arcs = np.broadcast_to(np.arange(n, dtype=np.int32), (U, n)).copy()
    ks, kd, ka, aa, asc = jax.jit(jax.vmap(
        lambda c, f, a: tk.recombine_topk(
            c, f, a, jnp.float32(1e9), kcap=kcap, nlat=nlat)
    ))(jnp.asarray(cand), jnp.asarray(fdst), jnp.asarray(arcs))
    assert aa.shape == (U, kcap, nlat) and asc.shape == (U, kcap, nlat)
    for u in range(U):
        rw, rd, raa, ras = ref_select_lat(cand[u], fdst[u], arcs[u], 1e9,
                                          kcap, nlat)
        got = lat_by_dst(np.asarray(kd[u]), np.asarray(ks[u]),
                         np.asarray(aa[u]), np.asarray(asc[u]))
        assert got == lat_by_dst(rd, rw, raa, ras)


def test_duplicate_heavy_recombination():
    """Many candidates per dst: recombination must keep exactly the max
    arc per destination (ties impossible: distinct scores)."""
    rng = np.random.default_rng(3)
    n, kcap = 4096, 128
    fdst = rng.integers(0, 60, n).astype(np.int32)    # ~68 cands per dst
    cand = rng.permutation(n).astype(np.float32) / 97
    arcs = np.arange(n, dtype=np.int32)
    rs, rd, ra = ref_select(cand, fdst, arcs, 1e9, kcap)
    ks, kd, ka = select(cand, fdst, arcs, 1e9, kcap)
    assert pairs(ks, kd, ka) == pairs(rs, rd, ra)
    # at most one survivor per destination
    alive = np.asarray(ks) > NEG / 2
    assert len(set(np.asarray(kd)[alive].tolist())) == int(alive.sum())


def test_merge_shape_with_neg_padding():
    """The sharded decoder's cross-shard merge: two per-shard top-kcap
    candidate sets (each already dst-unique WITHIN a shard, duplicated
    ACROSS shards) with NEG padding.  Padding must never surface and the
    merged top-kcap must equal the sort reference."""
    rng = np.random.default_rng(9)
    kcap = 128
    sets = []
    for s in range(2):
        d = rng.choice(500, kcap, replace=False).astype(np.int32)
        v = (rng.standard_normal(kcap) * 4).astype(np.float32)
        a = (rng.integers(0, 10_000, kcap)).astype(np.int32)
        sets.append((v, d, a))
    gv = np.concatenate([s[0] for s in sets])
    gd = np.concatenate([s[1] for s in sets])
    ga = np.concatenate([s[2] for s in sets])
    pad = 4 * 128 - len(gv)
    gv = np.concatenate([gv, np.full(pad, NEG, np.float32)])
    gd = np.concatenate([gd, np.zeros(pad, np.int32)])
    ga = np.concatenate([ga, np.full(pad, -1, np.int32)])
    rs, rd, ra = ref_select(gv, gd, ga, 1e9, kcap)
    ks, kd, ka = select(gv, gd, ga, 1e9, kcap)
    got = pairs(ks, kd, ka)
    assert got == pairs(rs, rd, ra)
    # padding (arc = -1) must never appear among the alive winners
    assert all(a != -1 for *_, a in got)
