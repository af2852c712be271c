"""Round-5 VERDICT item 1 suite gate (reduced scale of
tools/exp_tri_train.py): tied-triphone AM TRAINED FROM AUDIO through the
production front-end decodes beamformed reverberant speech better than
(a) the single mic and (b) the trained monophone system.

Matched-front-end training is load-bearing (PRUNING.md round 5): both
AMs train on reverberant 8-ch sim → MVDR → MFCC/CMN, exactly the eval
front-end.  The tri graph decodes DENSE (XLA sorts) here — split==dense
is covered by test_split_decoder; this gate is about the training
pipeline (mono EM → align → data tree stats → tying → tied EM), the
triphone HCLG build, and the beamformer/tying inequalities.

Margins frozen from the calibration run (see test bodies)."""

import numpy as np
import pytest

import jax.numpy as jnp

from golden import corpus as gcorpus
from golden import room as groom
from dsr.asr import phone_task, triphone, tritrain
from dsr.asr.am import gmm as jgmm
from dsr.asr.decoder import topk_decoder as tk
from dsr.asr.fsm import hclg, lm, native
from dsr.asr.fsm.hclg import SymbolTable
from dsr.asr.fsm.packed import pack
from dsr.asr.train import trainer
from dsr.config import ArrayGeometry, FilterbankConfig
from dsr.ops import beamforming as jbf
from dsr.ops import features as jft
from dsr.ops import filterbank as jfb
from dsr.utils.metrics import WerScorer

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native WFST core not built"
)

SR = 16000.0
ROOM = np.array([5.0, 4.0, 3.0])
CENTER = np.array([2.0, 1.0, 1.2])
SRCPOS = np.array([0.6, 1.5, 0.3])
NDIST = 60
TRAIN_UTTS = 30
E_UTTS = 6


def _feats(x):
    return np.asarray(jft.cmn(jft.mfcc(np.asarray(x, np.float32), SR)))


@pytest.fixture(scope="module")
def system():
    cfg = FilterbankConfig(M=256, m=4, r=2)
    POS = np.asarray(ArrayGeometry.circular(8, 0.10).positions)
    taus = (groom.steering_delays(POS, SRCPOS, 343.0, SR) / SR).astype(np.float32)
    v = jbf.steering_vectors(jnp.asarray(taus), cfg.M, SR)
    Gamma = jbf.diffuse_coherence(POS, cfg.M, SR, 343.0)
    w_mvdr = jbf.mvdr_weights(v, Gamma, 1e-2)

    def simulate(x, rng):
        return groom.simulate(x, POS, SRCPOS, SR, snr_db=30.0,
                              diffuse_snr_db=2.0, rng=rng, room_dim=ROOM,
                              array_center=CENTER, reflect=0.75,
                              max_order=2).astype(np.float32)

    def mvdr_of(xm):
        A = jfb.analysis(xm, cfg)
        return np.asarray(jfb.synthesis(jbf.apply_weights(A, w_mvdr), cfg,
                                        xm.shape[-1]))

    # matched-front-end training features
    task = phone_task.PhoneTask(gcorpus.VOCAB, states_per_phone=2)
    tsim = np.random.default_rng(23)
    train_corpus = gcorpus.make_corpus(TRAIN_UTTS, seed=0)
    feats = [_feats(mvdr_of(simulate(x, tsim))) for _, x in train_corpus]
    trans = [ws for ws, _ in train_corpus]
    mono = trainer.train(task, feats, trans, num_comp=2, iters=4)
    tri = tritrain.train_tied_triphone(task, mono, feats, trans, iters=3)

    # distractor-lexicon graphs
    rng = np.random.default_rng(0)
    plist = sorted(gcorpus.PHONES)
    lexicon = {w: tuple(gcorpus.WORDS[w]) for w in gcorpus.VOCAB}
    for i in range(NDIST):
        n = int(rng.integers(2, 6))
        lexicon[f"w{i:04d}"] = tuple(
            plist[j] for j in rng.integers(0, len(plist), n))
    vocab_all = sorted(lexicon)
    words = SymbolTable(vocab_all)
    texts = [[vocab_all[j] for j in rng.integers(0, len(vocab_all),
                                                 rng.integers(2, 6))]
             for _ in range(1500)]
    G = lm.arpa_to_fst(lm.train_arpa_bigram(texts, vocab_all), words)
    nCLG, tbl, seen = triphone.build_clg_native(lexicon, task.phones, words, G)
    tri_graph, _ = triphone.finish_tri_hclg_native(
        nCLG, tbl, tri.tree, task.phones, task.spp, seen_tris=seen)
    tg_t = tk.build_token_graph(tri_graph)
    L, ndis = hclg.build_lexicon_fst(lexicon, task.phones, words,
                                     sil_phone="sil")
    Hm = hclg.build_hmm_fst(len(task.phones) - 1, ndis,
                            states_per_phone=task.spp)
    tg_m = tk.build_token_graph(
        pack(hclg.compose_hclg(Hm, L, G, len(task.phones) - 1, ndis)))

    # eval decodes
    simrng = np.random.default_rng(11)
    sc = {(s, f): WerScorer() for s in ("mono", "tri")
          for f in ("single", "mvdr")}
    for ref, x in gcorpus.make_corpus(E_UTTS, seed=300):
        xm = simulate(x, simrng)
        for fname, sig in (("single", xm[0]), ("mvdr", mvdr_of(xm))):
            ft = jnp.asarray(_feats(sig))
            o_t, _ = tk.decode(tg_t, jgmm.loglik(tri.params, ft),
                               kcap=512, beam=80.0)
            sc[("tri", fname)].add(
                list(ref), [words.name(int(w)) for w in np.asarray(o_t) if w])
            o_m, _ = tk.decode(tg_m, jgmm.loglik(mono, ft),
                               kcap=256, beam=60.0)
            sc[("mono", fname)].add(
                list(ref), [words.name(int(w)) for w in np.asarray(o_m) if w])
    return tri, {k: v.wer for k, v in sc.items()}


def test_tied_triphone_trained_from_data(system):
    tri, _ = system
    assert tri.stats_contexts > tri.tree.num_leaves > len("aeiou")
    # tying is data-driven, non-trivial, and the tied EM converged to
    # finite parameters
    assert np.isfinite(np.asarray(tri.params.means)).all()


def test_beamforming_wins_under_trained_tri(system):
    _, wer = system
    assert wer[("tri", "mvdr")] < wer[("tri", "single")]


def test_tying_wins_or_matches_on_production_frontend(system):
    _, wer = system
    assert wer[("tri", "mvdr")] <= wer[("mono", "mvdr")] + 1e-9
