"""Triphone system gates: decision tree, C transducer, full triphone HCLG
decode with tied-state GMMs trained from monophone alignments."""

import numpy as np
import pytest

import jax.numpy as jnp

from golden import corpus as gcorpus
from dsr.asr import path as apath
from dsr.asr import phone_task, tree as ptree, triphone
from dsr.asr.am import gmm as jgmm
from dsr.asr.decoder import wfst_decoder as wd
from dsr.asr.fsm import hclg, lm
from dsr.asr.fsm.packed import pack
from dsr.asr.train import ml, trainer
from dsr.ops import features as jft
from dsr.utils.metrics import WerScorer

SR = 16000.0


def _feats(x):
    return np.asarray(jft.cmn(jft.mfcc(np.asarray(x, np.float32), SR)))


def _phone_seq(task, words):
    seq = ["sil"]
    for w in words:
        seq.extend(task.lexicon[w])
        seq.append("sil")
    return seq


@pytest.fixture(scope="module")
def tri_system():
    task = phone_task.PhoneTask(gcorpus.VOCAB, states_per_phone=2)
    corpus = gcorpus.make_corpus(60, seed=0)
    feats = [_feats(x) for _, x in corpus]
    transcripts = [ws for ws, _ in corpus]
    mono = trainer.train(task, feats, transcripts, num_comp=2, iters=4)

    # monophone alignments → tree stats
    aligns = []
    seqs = []
    for f, ws in zip(feats, transcripts):
        al = apath.force_align(task, mono, f, ws)
        seq = _phone_seq(task, ws)
        frames = triphone.context_of_alignment(al.segments, len(seq), task.spp)
        assert len(frames) == len(f)
        aligns.append(frames)
        seqs.append(seq)
    stats = ptree.accumulate_tree_stats(aligns, feats, seqs, task.spp)
    tree = ptree.build_tree(stats, min_gain=30.0, min_count=20.0)
    assert tree.num_leaves > task.num_pdfs / 2  # more leaves than... sanity

    # tied-state GMM training from the same alignments
    S = tree.num_leaves
    acc = ml.zero_accum(S, 2, 13)
    params0 = jgmm.GmmParams(
        jnp.zeros((S, 2, 13)), jnp.ones((S, 2, 13)),
        jnp.full((S, 2), -np.log(2.0)),
    )
    # flat-start tied GMMs from tree-mapped frame labels
    import jax

    for frames, f, seq in zip(aligns, feats, seqs):
        pdfs = np.asarray(
            [
                tree.lookup(
                    seq[pi - 1] if pi > 0 else "sil",
                    seq[pi],
                    seq[pi + 1] if pi + 1 < len(seq) else "sil",
                    pos,
                )
                for pi, pos in frames
            ],
            np.int32,
        )
        gamma = jax.nn.one_hot(pdfs, S, dtype=jnp.float32)
        acc = ml.accumulate(params0, jnp.asarray(f), gamma, acc)
    params = ml.mstep(acc)
    return task, tree, params, transcripts, mono


def test_tree_lookup_consistency(tri_system):
    task, tree, params, _, _ = tri_system
    a = tree.lookup("aa", "sh", "sil", 0)
    b = tree.lookup("aa", "sh", "sil", 0)
    assert a == b
    # unseen context still resolves to a valid leaf
    c = tree.lookup("tt", "sh", "kk", 1)
    assert 0 <= c < tree.num_leaves


def test_context_fst_maps_phones(tri_system):
    task, tree, params, _, _ = tri_system
    C, tbl = triphone.build_context_fst(task.phones, 0)
    # accepting tri(sil,a,b) tri(a,b,sil) must output phones a b
    a, b = task.phones["aa"], task.phones["sh"]
    sil = task.phones["sil"]
    syms = [tbl.tri(sil, a, b), tbl.tri(a, b, sil)]
    # path_weight over input side: need the eps-start arc then syms
    w = C.path_weight(syms)
    assert w < float("inf")


def test_triphone_hclg_decode_wer(tri_system):
    """Gate: the tied-triphone system must not be worse than monophone on
    the same eval (and stay under an absolute cap)."""
    task, tree, params, transcripts, mono = tri_system
    arpa = lm.train_arpa_bigram(transcripts, task.vocab)
    G = lm.arpa_to_fst(arpa, task.words)
    L, ndis = hclg.build_lexicon_fst(task.lexicon, task.phones, task.words, sil_phone="sil")
    HCLG = triphone.compose_hclg_tri(L, G, task.phones, tree, ndis, task.spp)
    graph = pack(HCLG)
    assert graph.pdf.max() < tree.num_leaves
    dev = wd.to_device(graph)
    Hm = hclg.build_hmm_fst(len(task.phones) - 1, ndis, states_per_phone=task.spp)
    dev_m = wd.to_device(pack(hclg.compose_hclg(Hm, L, G, len(task.phones) - 1, ndis)))
    sc = WerScorer()
    sc_m = WerScorer()
    for ref, x in gcorpus.make_corpus(8, seed=321):
        f = _feats(x)
        ll = np.asarray(jgmm.loglik(params, jnp.asarray(f)))
        olabs, _, _ = wd.decode(dev, ll)
        sc.add(ref, wd.words_from_olabels(np.asarray(olabs), task.words))
        ll_m = np.asarray(jgmm.loglik(mono, jnp.asarray(f)))
        olabs_m, _, _ = wd.decode(dev_m, ll_m)
        sc_m.add(ref, wd.words_from_olabels(np.asarray(olabs_m), task.words))
    assert sc.wer <= sc_m.wer + 1e-9, f"tri {sc} vs mono {sc_m}"
    assert sc.wer <= 0.35, str(sc)
