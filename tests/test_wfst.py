"""WFST algebra gates: each op preserves path weights on hand-built and
random machines; ARPA reader correctness; HCLG pipeline composes."""

import math
import random

import numpy as np
import pytest

from dsr.asr.fsm import EPS, Wfst
from dsr.asr.fsm import hclg, lm

INF = float("inf")


def _linear_fst(labels, weight_each=0.5):
    f = Wfst()
    s = f.add_state()
    f.set_start(s)
    for lab in labels:
        n = f.add_state()
        f.add_arc(s, lab, lab, weight_each, n)
        s = n
    f.set_final(s, 0.0)
    return f


def _random_acceptor(
    rng, n_states=6, n_labels=3, n_arcs=12, eps_frac=0.2, seed_final=True, acyclic=False
):
    """Random acceptor.  acyclic=True (arcs s→d with s<d) for determinize
    tests: weighted determinization of arbitrary *cyclic* machines need not
    terminate (twins property) — same behaviour as OpenFst."""
    f = Wfst()
    for _ in range(n_states):
        f.add_state()
    f.set_start(0)
    f.set_final(n_states - 1, round(rng.random(), 3))
    if seed_final and rng.random() < 0.5:
        f.set_final(rng.randrange(n_states), round(rng.random(), 3))
    for _ in range(n_arcs):
        s = rng.randrange(n_states)
        d = rng.randrange(n_states)
        if acyclic:
            if s == d:
                continue
            s, d = min(s, d), max(s, d)
        lab = 0 if rng.random() < eps_frac else rng.randrange(1, n_labels + 1)
        f.add_arc(s, lab, lab, round(rng.random(), 3), d)
    return f


def _enum_strings(n_labels, max_len):
    out = [[]]
    frontier = [[]]
    for _ in range(max_len):
        frontier = [s + [l] for s in frontier for l in range(1, n_labels + 1)]
        out.extend(frontier)
    return out


def _weights_equal(f1, f2, n_labels=3, max_len=4):
    for s in _enum_strings(n_labels, max_len):
        w1, w2 = f1.path_weight(s), f2.path_weight(s)
        if w1 == INF and w2 == INF:
            continue
        assert w1 == pytest.approx(w2, abs=1e-6), f"string {s}: {w1} vs {w2}"


def test_compose_linear():
    a = _linear_fst([1, 2, 3])
    # b maps 1→10, 2→20, 3→30
    b = Wfst()
    s = b.add_state()
    b.set_start(s)
    b.set_final(s, 0.0)
    for i, o in [(1, 10), (2, 20), (3, 30)]:
        b.add_arc(s, i, o, 0.25, s)
    c = a.compose(b)
    assert c.path_weight([1, 2, 3]) == pytest.approx(3 * 0.75)
    assert c.path_weight([1, 2]) == INF
    # olabels preserved
    olabs = []
    s = c.start
    for _ in range(3):
        arc = c.arcs[s][0]
        olabs.append(arc.olabel)
        s = arc.nextstate
    assert olabs == [10, 20, 30]


def test_rmepsilon_preserves_weights():
    rng = random.Random(0)
    for trial in range(8):
        f = _random_acceptor(rng)
        g = f.rmepsilon()
        for lst in g.arcs:
            for a in lst:
                assert not (a.ilabel == EPS and a.olabel == EPS)
        _weights_equal(f, g)


def test_determinize_preserves_weights_and_is_deterministic():
    rng = random.Random(1)
    for trial in range(8):
        f = _random_acceptor(rng, eps_frac=0.0, acyclic=True)
        d = f.determinize()
        for lst in d.arcs:
            labs = [a.ilabel for a in lst]
            assert len(labs) == len(set(labs)), "nondeterministic output"
        _weights_equal(f, d)


def test_minimize_preserves_weights_and_shrinks():
    rng = random.Random(2)
    for trial in range(6):
        f = _random_acceptor(rng, eps_frac=0.0, acyclic=True)
        d = f.determinize()
        m = d.minimize()
        assert m.num_states <= d.num_states
        _weights_equal(d, m)


def test_push_preserves_path_weights_up_to_constant():
    rng = random.Random(3)
    f = _random_acceptor(rng, eps_frac=0.0, acyclic=True)
    p = f.push()
    # all total path weights shift by d(start) — compare differences
    strings = [s for s in _enum_strings(3, 4) if f.path_weight(s) < INF]
    if len(strings) >= 2:
        base = f.path_weight(strings[0]) - p.path_weight(strings[0])
        for s in strings[1:]:
            assert f.path_weight(s) - p.path_weight(s) == pytest.approx(base, abs=1e-6)


def test_arpa_roundtrip_bigram():
    transcripts = [["ash", "east"], ["east", "oom"], ["ash", "east", "oom"], ["oom"]]
    vocab = ["ash", "east", "oom"]
    arpa = lm.train_arpa_bigram(transcripts, vocab)
    grams = lm.parse_arpa(arpa)
    assert 1 in grams and 2 in grams
    words = hclg.SymbolTable(vocab)
    G = lm.arpa_to_fst(arpa, words)
    assert G.num_states >= 1
    # a seen bigram path must be cheaper than an unseen one (via backoff)
    seen = G.path_weight([words["ash"], words["east"]])
    unseen = G.path_weight([words["east"], words["ash"]])
    assert seen < unseen


def test_lexicon_disambig_and_determinizable():
    phones = hclg.SymbolTable(["sil", "aa", "sh", "iy"])
    words = hclg.SymbolTable(["ash", "ash2", "a"])
    lexicon = {"ash": ("aa", "sh"), "ash2": ("aa", "sh"), "a": ("aa",)}
    L, ndis = hclg.build_lexicon_fst(lexicon, phones, words, sil_phone="sil")
    assert ndis >= 2  # homophones + prefix need disambig
    G = hclg.build_unigram_g(words)
    LG = L.compose(G).rmepsilon().determinize()
    assert LG.num_states > 0


def test_hclg_composes_and_packs():
    from dsr.asr.fsm.packed import pack

    phones = hclg.SymbolTable(["sil", "aa", "sh", "iy", "ss", "tt"])
    words = hclg.SymbolTable(["ash", "east"])
    lexicon = {"ash": ("aa", "sh"), "east": ("iy", "ss", "tt")}
    L, ndis = hclg.build_lexicon_fst(lexicon, phones, words, sil_phone="sil")
    G = hclg.build_unigram_g(words)
    LG = L.compose(G).rmepsilon().determinize()
    H = hclg.build_hmm_fst(len(phones) - 1, ndis, states_per_phone=2)
    HCLG = hclg.compose_hclg(H, L, G, len(phones) - 1, ndis)
    g = pack(HCLG)
    assert g.num_arcs > 0 and g.num_states > 0
    # all pdfs in range
    n_pdfs = (len(phones) - 1) * 2
    assert g.pdf.min() >= 0 and g.pdf.max() < n_pdfs
