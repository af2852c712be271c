"""LVCSR config-4 gates: the synthetic large-vocab HCLG builds at scale,
the direct LG constructor equals generic composition, and graph-sharded
decode equals single-device decode on a ≥10⁴-state graph (SURVEY.md
§2.3 graph sharding; BASELINE.json config 4)."""

import numpy as np
import pytest

from dsr.asr import lvcsr
from dsr.asr.decoder import topk_decoder as tk
from dsr.asr.decoder import wfst_decoder as wd
from dsr.asr.fsm import hclg, lm, native
from dsr.asr.fsm.packed import pack
from dsr.config import MeshConfig
from dsr.parallel import make_mesh
from dsr.parallel.decoder import make_sharded_decode

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native WFST core not built"
)


@pytest.fixture(scope="module")
def task():
    # ~43k states / ~90k arcs; builds in ~1 s, cached afterwards
    return lvcsr.build_task(lvcsr.LvcsrConfig(vocab_size=300, n_tokens=5000, branching=3))


def test_lvcsr_graph_scale_and_shape(task):
    g = task.graph
    assert g.num_states >= 10_000
    assert g.num_arcs >= 50_000
    # the late-label lexicon bounds out-degree by the phone inventory,
    # NOT the vocabulary — the property that keeps token tables narrow
    # (small slack: compose's joint eps:eps filter moves add a few arcs
    # where back-off escapes meet the trie fan-out)
    deg = np.bincount(g.src, minlength=g.num_states)
    assert deg.max() <= len(task.phones) + 8
    # every arc is emitting (packing invariant)
    assert (g.pdf >= 0).all() and (g.pdf < task.num_pdfs).all()


def test_build_lg_direct_equals_composition():
    """build_lg_fst == connect(compose(L_end, G)) up to weighted language:
    decode parity on random logliks through the full HCLG."""
    rng = np.random.default_rng(1)
    lex = lvcsr.make_lexicon(25, rng, min_len=2, max_len=4)
    vocab = sorted(lex)
    words = hclg.SymbolTable(vocab + ["</s>", "<s>"])
    phones = hclg.SymbolTable(lvcsr.PHONE_INVENTORY + ["sil"])
    text = lvcsr.make_text(vocab, 400, 3, rng)
    arpa = lm.train_arpa_ngram(text, vocab, order=2)
    G = lm.arpa_to_fst(arpa, words)

    LG_direct = hclg.build_lg_fst(lex, phones, words, G, sil_phone="sil")
    L, _ = hclg.build_lexicon_fst(lex, phones, words, sil_phone="sil", olabel_at="end")
    LG_comp = L.compose(G)

    H = hclg.build_hmm_fst(len(phones) - 1, 0, 2)
    graphs = []
    for LG in (LG_direct, LG_comp):
        HLG = H.compose(LG.determinize())
        graphs.append(pack(HLG.rmepsilon().connect()))
    P = (len(phones) - 1) * 2
    tg_a, tg_b = (tk.build_token_graph(g) for g in graphs)
    for seed in range(3):
        ll = np.random.default_rng(seed).standard_normal((40, P)).astype(np.float32) * 3
        ol_a, sc_a = tk.decode(tg_a, ll, kcap=min(graphs[0].num_states, 4096))
        ol_b, sc_b = tk.decode(tg_b, ll, kcap=min(graphs[1].num_states, 4096))
        assert abs(float(sc_a) - float(sc_b)) < 1e-2
        wa = [int(o) for o in np.asarray(ol_a) if o]
        wb = [int(o) for o in np.asarray(ol_b) if o]
        assert wa == wb


def test_lvcsr_sharded_decode_matches_single(task):
    tg = tk.build_token_graph(task.graph)
    mesh = make_mesh(MeshConfig(data=2, model=4))
    kcap, beam = 512, 1e9
    run = make_sharded_decode(mesh, tg, kcap=kcap, beam=beam)
    U, T = 2, 60
    rng = np.random.default_rng(7)
    lls = rng.standard_normal((U, T, task.num_pdfs)).astype(np.float32) * 2
    lens = np.asarray([T, T - 13], np.int32)
    olabs_sh, scores_sh = run(lls, lens)
    for i in range(U):
        ol1, sc1 = tk.decode(tg, lls[i], kcap=kcap, beam=beam, length=int(lens[i]))
        assert abs(float(scores_sh[i]) - float(sc1)) < 1e-2
        w_sh = [int(o) for o in np.asarray(olabs_sh[i])[: lens[i]] if o]
        w_1 = [int(o) for o in np.asarray(ol1)[: lens[i]] if o]
        assert w_sh == w_1


def test_lvcsr_sharded_beam_pruned_matches_single(task):
    """Beam pruning must behave identically sharded vs single (the beam is
    applied after the replicated merge)."""
    tg = tk.build_token_graph(task.graph)
    mesh = make_mesh(MeshConfig(data=2, model=4))
    kcap, beam = 256, 15.0
    run = make_sharded_decode(mesh, tg, kcap=kcap, beam=beam)
    U, T = 2, 40
    rng = np.random.default_rng(11)
    lls = rng.standard_normal((U, T, task.num_pdfs)).astype(np.float32) * 2
    lens = np.asarray([T, T], np.int32)
    olabs_sh, scores_sh = run(lls, lens)
    for i in range(U):
        ol1, sc1 = tk.decode(tg, lls[i], kcap=kcap, beam=beam)
        assert abs(float(scores_sh[i]) - float(sc1)) < 1e-2
        assert [int(o) for o in np.asarray(olabs_sh[i]) if o] == [
            int(o) for o in np.asarray(ol1) if o
        ]


def test_lvcsr_wer_zero_on_synthetic_am(task):
    """End-to-end LVCSR recognition gate: IN-DOMAIN sentences (the LM's own
    training distribution), rendered through the lexicon/HMM conventions
    with a well-separated synthetic AM, must decode at 0 WER through the
    43k-state trigram HCLG — lexicon, LM, HMM topology and decoder
    semantics all have to agree for this to hold.  (Out-of-domain word
    pairs decode through the back-off arcs but can LEGITIMATELY lose to a
    homophone with better LM score — random pronunciations collide — so
    the exact gate uses in-domain text.)"""
    from dsr.asr.am import gmm as jgmm
    from dsr.utils.metrics import WerScorer
    import jax.numpy as jnp

    cfg = task.cfg
    # reproduce the LM training text (same rng consumption as build_task)
    rng0 = np.random.default_rng(cfg.seed)
    lex = lvcsr.make_lexicon(cfg.vocab_size, rng0)
    vocab = sorted(lex)
    text = lvcsr.make_text(vocab, cfg.n_tokens, cfg.branching, rng0)
    rng = np.random.default_rng(5)
    params = lvcsr.synthetic_am(task)
    tg = tk.build_token_graph(task.graph)
    sc = WerScorer()
    for sent in [s[:5] for s in text[:4]]:
        feats = lvcsr.synthesize_utterance(task, sent, rng)
        ll = jgmm.loglik(params, jnp.asarray(feats))
        olabs, _ = tk.decode(tg, ll, kcap=256, beam=60.0)
        hyp = [task.words.name(int(w)) for w in np.asarray(olabs) if w]
        sc.add(sent, hyp)
    assert sc.wer == 0.0, str(sc)


def test_lvcsr_backoff_path_decodes_unseen_bigram(task):
    """Unseen word pairs remain REACHABLE through the LM back-off arcs:
    with an unambiguous second word the decoder must recover it even
    though the bigram never occurred in training."""
    from dsr.asr.am import gmm as jgmm
    import jax.numpy as jnp

    cfg = task.cfg
    rng0 = np.random.default_rng(cfg.seed)
    lex = lvcsr.make_lexicon(cfg.vocab_size, rng0)
    vocab = sorted(lex)
    text = lvcsr.make_text(vocab, cfg.n_tokens, cfg.branching, rng0)
    w1 = text[0][0]
    seen_after = {s[i + 1] for s in text for i in range(len(s) - 1) if s[i] == w1}
    # pick an unseen successor whose pronunciation is unique (no homophone)
    from collections import Counter

    pron_count = Counter(task.lexicon[w] for w in vocab)
    w2 = next(w for w in vocab
              if w not in seen_after and pron_count[task.lexicon[w]] == 1)
    rng = np.random.default_rng(9)
    feats = lvcsr.synthesize_utterance(task, [w1, w2], rng)
    ll = jgmm.loglik(lvcsr.synthetic_am(task), jnp.asarray(feats))
    tg = tk.build_token_graph(task.graph)
    # the MAP hypothesis may legitimately split the unseen word into
    # in-domain homophone pieces, so assert REACHABILITY via the lattice
    # oracle: a 0-error path for [w1, w2] must exist in the beam — it can
    # only get there through the back-off arcs
    out = tk.decode_with_tokens(tg, ll, kcap=512, beam=1e9, nlat=6)
    _, _, ts_, ta_, tsc_, aa, asc = out
    from dsr.asr.decoder import lattice as jlat

    lat = jlat.from_topk(ts_, ta_, tsc_, tg, aa, asc)
    ref_ids = [task.words[w1], task.words[w2]]
    assert lat.oracle_errors(ref_ids) == 0


def test_lvcsr_triphone_build_and_recognize():
    """Config-4 TRIPHONE path: trigram G -> det(LG) -> C -> likelihood-gain
    tied tree -> H_tri, all at-scale compositions through the native core;
    in-domain utterances with context-dependent acoustics decode exactly.

    Structure gates: tying is real (far fewer tied pdfs than seen
    triphone states, but more than monophone states — the tree used the
    left-context questions)."""
    from dsr.asr.am import gmm as jgmm
    import jax.numpy as jnp

    cfg = lvcsr.LvcsrConfig(vocab_size=300, n_tokens=5000, branching=3)
    task = lvcsr.build_task_tri(cfg)
    spp = cfg.states_per_phone
    n_mono = (len(task.phones) - 1) * spp
    assert task.build_stats["num_states"] >= 100_000
    assert task.build_stats["seen_triphones"] >= 10_000
    assert n_mono < task.num_pdfs < task.build_stats["seen_triphones"] * spp

    rng0 = np.random.default_rng(cfg.seed)
    lex = lvcsr.make_lexicon(cfg.vocab_size, rng0)
    vocab = sorted(lex)
    text = lvcsr.make_text(vocab, cfg.n_tokens, cfg.branching, rng0)
    params = lvcsr.synthetic_am_tri(task)
    tg = tk.build_token_graph(task.graph)
    rng = np.random.default_rng(7)
    for sent in [s[:3] for s in text[:2]]:
        feats = lvcsr.synthesize_utterance_tri(task, sent, rng)
        ll = jgmm.loglik(params, jnp.asarray(feats))
        olabs, _ = tk.decode(tg, ll, kcap=192, beam=60.0)
        hyp = [task.words.name(int(w)) for w in np.asarray(olabs) if w]
        assert hyp == sent, (sent, hyp)
