"""Native (C++) WFST core vs the pure-Python oracle.

The Python `_compose_py` / `_determinize_py` / `_rmepsilon_py` bodies are
the tested semantics oracle; native/wfst.cpp must agree exactly on state
counts and on path weights.  Runs only if libdsrnative.so is built.
"""

import numpy as np
import pytest

from dsr.asr.fsm import native
from dsr.asr.fsm.wfst import EPS, INF, Wfst

pytestmark = pytest.mark.skipif(not native.available(), reason="native lib not built")


def _random_fst(rng, ns=12, na=30, nlabels=5, eps_frac=0.25, acyclic=False):
    f = Wfst()
    for _ in range(ns):
        f.add_state()
    f.set_start(0)
    for _ in range(na):
        s = int(rng.integers(0, ns - 1 if acyclic else ns))
        d = int(rng.integers(s + 1, ns)) if acyclic else int(rng.integers(0, ns))
        il = 0 if rng.random() < eps_frac else int(rng.integers(1, nlabels + 1))
        ol = 0 if rng.random() < eps_frac else int(rng.integers(1, nlabels + 1))
        f.add_arc(s, il, ol, float(np.round(rng.random() * 4, 3)), d)
    for s in rng.choice(ns, size=3, replace=False):
        f.set_final(int(s), float(np.round(rng.random(), 3)))
    return f


def _sample_paths(f, rng, n=60, max_len=6):
    """Random ilabel strings biased toward labels the machine accepts."""
    seqs = [[]]
    for _ in range(n):
        seqs.append([int(x) for x in rng.integers(1, 6, size=rng.integers(1, max_len))])
    return seqs


def _assert_equivalent(a: Wfst, b: Wfst, rng, check_counts=True):
    if check_counts:
        assert a.num_states == b.num_states
        assert a.num_arcs == b.num_arcs
    for seq in _sample_paths(a, rng):
        wa, wb = a.path_weight(seq), b.path_weight(seq)
        if wa == INF and wb == INF:
            continue
        assert abs(wa - wb) < 1e-4, (seq, wa, wb)


def test_compose_matches_python():
    rng = np.random.default_rng(0)
    for trial in range(8):
        A = _random_fst(rng, acyclic=trial % 2 == 0)
        B = _random_fst(rng, eps_frac=0.15, acyclic=trial % 2 == 0)
        C_nat = native.compose(A, B)
        C_py = A._compose_py(B)
        _assert_equivalent(C_nat, C_py, rng)


def test_determinize_matches_python():
    rng = np.random.default_rng(1)
    for trial in range(8):
        A = _random_fst(rng, eps_frac=0.0, acyclic=True)  # eps-free, acyclic
        D_nat = native.determinize(A)
        D_py = A._determinize_py()
        # same subset collection → same state count; arc order may differ
        assert D_nat.num_states == D_py.num_states
        _assert_equivalent(D_nat, D_py, rng, check_counts=False)
        # determinism: at most one arc per (state, ilabel, olabel)
        for s in range(D_nat.num_states):
            labs = [(a.ilabel, a.olabel) for a in D_nat.arcs[s]]
            assert len(labs) == len(set(labs))


def test_rmepsilon_matches_python():
    rng = np.random.default_rng(2)
    for trial in range(6):
        A = _random_fst(rng, eps_frac=0.4, acyclic=True)
        R_nat = native.rmepsilon(A)
        R_py = A._rmepsilon_py()
        _assert_equivalent(R_nat, R_py, rng)
        for s in range(R_nat.num_states):
            for a in R_nat.arcs[s]:
                assert not (a.ilabel == EPS and a.olabel == EPS)


def test_determinize_divergence_guard():
    f = Wfst()
    for _ in range(3):
        f.add_state()
    f.set_start(0)
    # classic non-twins machine: two cycles with different weights on the
    # same label — weighted determinization diverges
    f.add_arc(0, 1, 1, 0.0, 1)
    f.add_arc(0, 1, 1, 1.0, 2)
    f.add_arc(1, 1, 1, 0.0, 1)
    f.add_arc(2, 1, 1, 2.0, 2)
    f.set_final(1)
    f.set_final(2)
    with pytest.raises(RuntimeError):
        native.determinize(f, max_states=2000)


def test_hclg_pipeline_native_equals_python():
    """Full H∘(L∘G) build with native on vs off must yield graphs with the
    same accepted-path weights (end-to-end dispatch check)."""
    from dsr.asr.fsm import hclg as _hclg
    from dsr.asr.phone_task import PhoneTask
    from golden import corpus as gcorpus

    rng = np.random.default_rng(3)
    task = PhoneTask(gcorpus.VOCAB[:3], states_per_phone=2)
    G = _hclg.build_unigram_g(task.words)
    L, ndis = _hclg.build_lexicon_fst(task.lexicon, task.phones, task.words, "sil")
    H = _hclg.build_hmm_fst(len(task.phones) - 1, ndis, task.spp)
    nat = _hclg.compose_hclg(H, L, G, len(task.phones) - 1, ndis)
    native.set_enabled(False)
    try:
        py = _hclg.compose_hclg(H, L, G, len(task.phones) - 1, ndis)
    finally:
        native.set_enabled(True)
    assert nat.num_states == py.num_states
    assert nat.num_arcs == py.num_arcs
    _assert_equivalent(nat, py, rng, check_counts=False)
