"""End-to-end HCLG decode gate (BASELINE.json config-4 path at small scale):
phone GMM-HMM training → HCLG (bigram LM) → dense batched WFST decode → WER,
with a NumPy golden replica of the decoder for exact parity."""

import numpy as np
import pytest

from golden import corpus as gcorpus
from dsr.asr import phone_task
from dsr.asr.am import gmm as jgmm
from dsr.asr.decoder import wfst_decoder as wd
from dsr.asr.fsm import hclg, lm
from dsr.asr.fsm.packed import pack
from dsr.asr.train import trainer
from dsr.ops import features as jft
from dsr.utils.metrics import WerScorer

SR = 16000.0


def _feats(x):
    f = jft.mfcc(np.asarray(x, np.float32), SR)
    return np.asarray(jft.cmn(f))


@pytest.fixture(scope="module")
def system():
    task = phone_task.PhoneTask(gcorpus.VOCAB, states_per_phone=2)
    train_corpus = gcorpus.make_corpus(60, seed=0)
    feats = [_feats(x) for _, x in train_corpus]
    transcripts = [ws for ws, _ in train_corpus]
    params = trainer.train(task, feats, transcripts, num_comp=2, iters=4)
    # decoding graph with a bigram LM trained on the training transcripts
    arpa = lm.train_arpa_bigram(transcripts, task.vocab)
    G = lm.arpa_to_fst(arpa, task.words)
    L, ndis = hclg.build_lexicon_fst(task.lexicon, task.phones, task.words, sil_phone="sil")
    H = hclg.build_hmm_fst(len(task.phones) - 1, ndis, states_per_phone=task.spp)
    HCLG = hclg.compose_hclg(H, L, G, len(task.phones) - 1, ndis)
    graph = pack(HCLG)
    return task, params, graph


def _golden_dense_decode(graph, ll):
    """NumPy replica of the dense arc-expansion Viterbi decoder."""
    NEG = -1e30
    S = graph.num_states
    scores = np.full(S, NEG)
    scores[graph.start] = 0.0
    w = -graph.weight.astype(np.float64)
    T = len(ll)
    bps = np.full((T, S), -1, np.int64)
    for t in range(T):
        cand = scores[graph.src] + w + ll[t, graph.pdf]
        new = np.full(S, NEG)
        np.maximum.at(new, graph.dst, cand)
        best = np.full(S, -1, np.int64)
        is_best = cand >= new[graph.dst] - 1e-6
        np.maximum.at(best, graph.dst[is_best], np.nonzero(is_best)[0])
        scores, bps[t] = new, best
    fin = np.where(np.isfinite(graph.final_weight), -graph.final_weight, NEG)
    end = int(np.argmax(scores + fin))
    olabs = []
    state = end
    for t in range(T - 1, -1, -1):
        arc = bps[t, state]
        assert arc >= 0
        if graph.olabel[arc]:
            olabs.append(int(graph.olabel[arc]))
        state = int(graph.src[arc])
    return list(reversed(olabs)), float((scores + fin)[end])


def test_hclg_decode_wer_and_golden_parity(system):
    task, params, graph = system
    dev_graph = wd.to_device(graph)
    eval_corpus = gcorpus.make_corpus(8, seed=300)
    sc = WerScorer()
    sc_g = WerScorer()
    for ref, x in eval_corpus:
        f = _feats(x)
        ll = np.asarray(jgmm.loglik(params, f))
        olabs, arcs, score = wd.decode(dev_graph, ll)
        hyp = wd.words_from_olabels(np.asarray(olabs), task.words)
        sc.add(ref, hyp)
        g_olabs, g_score = _golden_dense_decode(graph, ll.astype(np.float64))
        hyp_g = [task.words.name(o) for o in g_olabs]
        sc_g.add(ref, hyp_g)
        assert abs(float(score) - g_score) < 0.5, (float(score), g_score)
    assert sc.wer <= 0.15, str(sc)
    assert sc_g.wer == pytest.approx(sc.wer, abs=1e-9), f"golden {sc_g} vs jax {sc}"


def test_decode_batch_matches_single(system):
    task, params, graph = system
    dev_graph = wd.to_device(graph)
    eval_corpus = gcorpus.make_corpus(3, seed=301)
    feats = [_feats(x) for _, x in eval_corpus]
    lls = [np.asarray(jgmm.loglik(params, f)) for f in feats]
    T_max = max(len(l) for l in lls)
    P = lls[0].shape[1]
    batch = np.zeros((len(lls), T_max, P), np.float32)
    lens = np.zeros(len(lls), np.int32)
    for i, l in enumerate(lls):
        batch[i, : len(l)] = l
        lens[i] = len(l)
    olabs_b, arcs_b, scores_b = wd.decode_batch(dev_graph, batch, lens)
    for i, l in enumerate(lls):
        olabs_s, _, score_s = wd.decode(dev_graph, l)
        hyp_s = wd.words_from_olabels(np.asarray(olabs_s), task.words)
        hyp_b = wd.words_from_olabels(np.asarray(olabs_b[i])[: lens[i]], task.words)
        assert hyp_s == hyp_b
        assert abs(float(score_s) - float(scores_b[i])) < 1e-3
