"""Exact lattice gates: sum-semiring forward-backward posteriors and the
exact oracle over a true (multi-incoming-arc) lattice, from
decode_with_tokens(nlat>0).  Reference asr/lattice [K]: forward-backward
link posteriors, oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from dsr.asr.decoder import lattice as jlat
from dsr.asr.decoder import topk_decoder as tk
from dsr.asr.fsm.packed import PackedGraph

A_WORD, B_WORD = 7, 9


def _two_path_graph():
    """0 --(pdf0,'A')--> 1 --(pdf1,eps)--> 3(final)
       0 --(pdf2,'B')--> 2 --(pdf3,eps)--> 3(final)"""
    src = np.array([0, 0, 1, 2], np.int32)
    dst = np.array([1, 2, 3, 3], np.int32)
    pdf = np.array([0, 2, 1, 3], np.int32)
    ola = np.array([A_WORD, B_WORD, 0, 0], np.int32)
    w = np.zeros(4, np.float32)
    fin = np.full(4, np.inf, np.float32)
    fin[3] = 0.0
    return PackedGraph(src, pdf, ola, w, dst, 0, fin, 4)


@pytest.fixture(scope="module")
def twopath():
    g = _two_path_graph()
    tg = tk.build_token_graph(g)
    # B's path is slightly better acoustically
    ll = np.full((2, 4), -10.0, np.float32)
    ll[0, 0], ll[0, 2] = 1.0, 1.1
    ll[1, 1], ll[1, 3] = 1.0, 1.05
    out = tk.decode_with_tokens(tg, jnp.asarray(ll), kcap=4, nlat=3)
    olabs, score, ts_, ta_, tsc_, aa, asc = out
    lat = jlat.from_topk(ts_, ta_, tsc_, tg, aa, asc)
    return lat, ll, olabs, score


def test_one_best_is_b(twopath):
    lat, ll, olabs, score = twopath
    words, lscore = lat.one_best()
    assert words == [B_WORD]
    assert abs(lscore - (1.1 + 1.05)) < 1e-4


def test_forward_backward_exact_logZ(twopath):
    lat, ll, _, _ = twopath
    alpha, beta, logZ, post = lat.forward_backward()
    pa = ll[0, 0] + ll[1, 1]
    pb = ll[0, 2] + ll[1, 3]
    want = np.logaddexp(pa, pb)
    assert abs(logZ - want) < 1e-4
    # per-frame link posteriors sum to 1 (every path crosses one arc/frame)
    sums = post.sum(axis=(1, 2))
    assert np.allclose(sums, 1.0, atol=1e-4)
    # link posterior of the A arc matches its exact path posterior
    p_a = np.exp(pa - want)
    t0_arcs = np.asarray(lat.alt_arcs[0]).reshape(-1)
    t0_post = post[0].reshape(-1)
    a_arc_mask = np.array([a >= 0 and lat.olabel_of_arc[a] == A_WORD for a in t0_arcs])
    assert abs(t0_post[a_arc_mask].sum() - p_a) < 1e-4


def test_oracle_beats_wrong_one_best(twopath):
    lat, _, _, _ = twopath
    # reference is A; the 1-best says B (1 substitution) but the lattice
    # contains the A path, so the exact oracle is 0
    words, _ = lat.one_best()
    assert words == [B_WORD]
    assert lat.oracle_errors([A_WORD]) == 0
    assert lat.oracle_errors([B_WORD]) == 0
    assert lat.oracle_errors([A_WORD, A_WORD]) == 1   # one deletion
    assert lat.oracle_errors([]) == 1                 # forced insertion


def test_node_posteriors_sum_per_frame_random_graph():
    rng = np.random.default_rng(0)
    S, P, T = 24, 6, 12
    n_arcs = 80
    src = rng.integers(0, S, n_arcs).astype(np.int32)
    dst = rng.integers(0, S, n_arcs).astype(np.int32)
    pdf = rng.integers(0, P, n_arcs).astype(np.int32)
    ola = rng.integers(0, 3, n_arcs).astype(np.int32)
    w = rng.random(n_arcs).astype(np.float32)
    fin = np.where(rng.random(S) < 0.3, 0.0, np.inf).astype(np.float32)
    g = PackedGraph(src, pdf, ola, w, dst, int(src[0]), fin, S)
    tg = tk.build_token_graph(g)
    ll = rng.standard_normal((T, P)).astype(np.float32)
    out = tk.decode_with_tokens(tg, jnp.asarray(ll), kcap=S, nlat=4)
    _, score, ts_, ta_, tsc_, aa, asc = out
    lat = jlat.from_topk(ts_, ta_, tsc_, tg, aa, asc)
    _, _, logZ, post = lat.forward_backward()
    assert np.isfinite(logZ)
    sums = post.sum(axis=(1, 2))
    # nlat=4 truncation can shave mass, never add: sums in (0, 1]
    assert np.all(sums <= 1.0 + 1e-4)
    assert np.all(sums > 0.05)
    # oracle is a lower bound on the 1-best's errors
    from dsr.utils.metrics import edit_distance

    hyp, _ = lat.one_best()
    for ref in ([1], [2, 1], [1, 2, 1], []):
        s, d, i, _ = edit_distance(ref, hyp)
        assert lat.oracle_errors(ref) <= s + d + i


def _random_lowdeg_graph(S=150, A=6, P=12, seed=3):
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(S, dtype=np.int32), A)
    dst = rng.integers(0, S, S * A).astype(np.int32)
    pdf = rng.integers(0, P, S * A).astype(np.int32)
    ola = rng.integers(0, 5, S * A).astype(np.int32)
    w = np.abs(rng.standard_normal(S * A)).astype(np.float32)
    fin = np.full(S, np.inf, np.float32)
    fin[rng.integers(0, S, 10)] = 0.0
    return PackedGraph(src, pdf, ola, w, dst, 0, fin, S), P


@pytest.mark.parametrize("beam", [1e9, 8.0])
def test_lattice_decode_kernel_matches_xla(beam):
    """Lattice mode (nlat=4) must leave the 1-best search untouched:
    olabels, score and token arrays equal the nlat=0 decode bit-for-bit,
    column 0 of the alternates is each token's own backpointer, and the
    lattice's 1-best equals the decoder's."""
    g, P = _random_lowdeg_graph()
    tg = tk.build_token_graph(g)
    ll = np.random.default_rng(5).standard_normal((30, P)).astype(np.float32) * 3
    out_l = tk.decode_with_tokens(tg, jnp.asarray(ll), kcap=128, beam=beam,
                                  nlat=4)
    out_1 = tk.decode_with_tokens(tg, jnp.asarray(ll), kcap=128, beam=beam)
    for a, b in zip(out_l[:5], out_1):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    arcs, alt = np.asarray(out_l[3]), np.asarray(out_l[5])
    assert np.array_equal(alt[..., 0], arcs)
    alt_s = np.asarray(out_l[6])
    live = alt >= 0
    assert np.all(alt_s[live] > -1e29) and np.all(alt_s[~live] < -1e29)
    # alternates are ordered best first within each token's run
    assert np.all(np.diff(np.where(live, alt_s, -1e30), axis=-1)[
        live[..., 1:]] <= 0)
    lat = jlat.from_topk(out_l[2], out_l[3], out_l[4], tg, out_l[5], out_l[6])
    want = [int(o) for o in np.asarray(out_1[0]) if o]
    assert lat.one_best()[0] == want
