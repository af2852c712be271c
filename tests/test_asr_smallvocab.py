"""ASR gates: GMM/Viterbi golden parity + the config-1 end-to-end slice
(8-ch DS beamform → MFCC → GMM-HMM Viterbi decode, WER on synthetic corpus;
BASELINE.json config 1, SURVEY.md §7 step 6)."""

import numpy as np
import pytest

from golden import corpus as gcorpus
from golden import gmm_hmm as ggh
from golden import room as groom
from dsr.asr import smallvocab
from dsr.asr.am import gmm as jgmm
from dsr.asr.decoder import viterbi as jvit
from dsr.asr.train import trainer
from dsr.config import ArrayGeometry, FilterbankConfig
from dsr.ops import beamforming as jbf
from dsr.ops import features as jft
from dsr.ops import filterbank as jfb
from dsr.utils.metrics import WerScorer

SR = 16000.0


def _mfcc_feats(x):
    f = jft.mfcc(np.asarray(x, np.float32), SR)
    return np.asarray(jft.cmn(f))


def test_gmm_loglik_parity():
    rng = np.random.default_rng(0)
    S, C, D, T = 7, 3, 13, 20
    g = ggh.DiagGmm(
        rng.standard_normal((S, C, D)),
        0.5 + rng.random((S, C, D)),
        np.log(rng.dirichlet(np.ones(C), size=S)),
    )
    x = rng.standard_normal((T, D))
    ll_g = g.loglik(x)
    ll_j = np.asarray(jgmm.loglik(jgmm.from_golden(g), x.astype(np.float32)))
    assert np.max(np.abs(ll_g - ll_j)) < 1e-2


def test_viterbi_parity():
    rng = np.random.default_rng(1)
    T, S = 50, 12
    ll = rng.standard_normal((T, S))
    A = np.log(rng.dirichlet(np.ones(S), size=S))
    init = np.log(rng.dirichlet(np.ones(S)))
    final = np.zeros(S)
    p_g, s_g = ggh.viterbi_dense(ll, A, init, final)
    p_j, s_j = jvit.viterbi(
        ll.astype(np.float32), A.astype(np.float32), init.astype(np.float32),
        final.astype(np.float32),
    )
    np.testing.assert_array_equal(np.asarray(p_j), p_g)
    assert abs(float(s_j) - s_g) < 1e-2


def test_forward_backward_parity():
    rng = np.random.default_rng(2)
    T, S = 30, 8
    ll = rng.standard_normal((T, S))
    A = np.log(rng.dirichlet(np.ones(S), size=S))
    init = np.log(rng.dirichlet(np.ones(S)))
    final = np.full(S, 0.0)
    gam_g, tot_g = ggh.forward_backward(ll, A, init, final)
    gam_j, tot_j = jvit.forward_backward(
        ll.astype(np.float32), A.astype(np.float32), init.astype(np.float32),
        final.astype(np.float32),
    )
    assert abs(float(tot_j) - tot_g) < 1e-2
    assert np.max(np.abs(np.asarray(gam_j) - gam_g)) < 1e-3


@pytest.fixture(scope="module")
def trained_model():
    train_corpus = gcorpus.make_corpus(60, seed=0)
    task = smallvocab.SmallVocabTask(gcorpus.VOCAB)
    feats = [_mfcc_feats(x) for _, x in train_corpus]
    transcripts = [ws for ws, _ in train_corpus]
    params = trainer.train(task, feats, transcripts, num_comp=2, iters=4)
    return task, params


def test_clean_decode_wer(trained_model):
    task, params = trained_model
    eval_corpus = gcorpus.make_corpus(10, seed=100)
    feats = [_mfcc_feats(x) for _, x in eval_corpus]
    hyps = trainer.decode(task, params, feats)
    sc = WerScorer()
    for (ref, _), hyp in zip(eval_corpus, hyps):
        sc.add(ref, hyp)
    assert sc.wer <= 0.05, str(sc)


def test_e2e_beamformed_decode_wer_and_golden_parity(trained_model):
    """Config 1: 8-ch DS beamform → MFCC → Viterbi; WER gate + golden WER parity."""
    task, params = trained_model
    cfg = FilterbankConfig(M=256, m=4, r=2)
    POS = np.asarray(ArrayGeometry.linear(8, 0.04).positions)
    eval_corpus = gcorpus.make_corpus(6, seed=200)
    rng = np.random.default_rng(7)
    pos = np.array([0.4, 1.8, 0.2])
    taus = (groom.steering_delays(POS, pos, 343.0, SR) / SR).astype(np.float32)
    v = jbf.steering_vectors(taus, cfg.M, SR)
    w = jbf.ds_weights(v)
    feats = []
    for _, x in eval_corpus:
        xm = groom.simulate(x, POS, pos, SR, snr_db=10.0, rng=rng).astype(np.float32)
        A = jfb.analysis(xm, cfg)
        Y = jbf.apply_weights(A, w)
        y = jfb.synthesis(Y, cfg, xm.shape[-1])
        feats.append(_mfcc_feats(y))
    hyps = trainer.decode(task, params, feats)
    sc = WerScorer()
    for (ref, _), hyp in zip(eval_corpus, hyps):
        sc.add(ref, hyp)
    assert sc.wer <= 0.15, str(sc)

    # Golden-pipeline WER parity: same features through golden GMM + Viterbi.
    g = ggh.DiagGmm(
        np.asarray(params.means, np.float64),
        np.asarray(params.variances, np.float64),
        np.asarray(params.logweights, np.float64),
    )
    A_d, init_d, final_d = task.decode_graph()
    sc_g = WerScorer()
    for (ref, _), f in zip(eval_corpus, feats):
        ll = g.loglik(np.asarray(f, np.float64))
        path, _ = ggh.viterbi_dense(ll, A_d, init_d, final_d)
        sc_g.add(ref, task.path_to_words(path))
    assert sc_g.wer == pytest.approx(sc.wer, abs=1e-9), f"golden {sc_g} vs jax {sc}"


def test_baum_welch_estep_matches_golden_and_trains():
    """trainer._estep_bw: soft-γ accumulators == golden forward-backward
    accumulate, and full BW training reaches 0 WER on the clean corpus."""
    rng = np.random.default_rng(7)
    task = smallvocab.SmallVocabTask(gcorpus.VOCAB[:3])
    corpus = gcorpus.make_corpus(8, min_words=1, max_words=2, seed=7)
    feats_list, transcripts = [], []
    for ws, x in corpus:
        ws = [w if w in task.vocab else task.vocab[0] for w in ws]
        feats_list.append(_mfcc_feats(x))
        transcripts.append(ws)

    state_seqs = [task.align_graph(ws)[0] for ws in transcripts]
    g0 = ggh.init_gmm_from_feats(feats_list, state_seqs, task.num_states, 2, rng)
    params = jgmm.from_golden(g0)
    feats, lengths = trainer.pad_corpus(feats_list)
    ids, A, init, final = trainer.pad_align_graphs(task, transcripts)
    acc_j, total_j = trainer._estep_bw(
        params, feats, lengths, ids, A, init, final, task.num_states
    )

    # golden soft E-step, utterance by utterance
    acc_g = ggh.GmmAccumulator(task.num_states, 2, feats.shape[-1])
    total_g = 0.0
    for u, f in enumerate(feats_list):
        ids_u, A_u, init_u, final_u = task.align_graph(transcripts[u])
        ll = g0.loglik(f)[:, ids_u]
        gam, tot = ggh.forward_backward(ll, A_u, init_u, final_u)
        gam_full = np.zeros((len(f), task.num_states))
        for l, s in enumerate(ids_u):
            gam_full[:, s] += gam[:, l]
        ggh.accumulate(g0, f, gam_full, acc_g)
        total_g += tot
    # f32 vs f64 log-domain γ noise is ~1e-3; compare accumulators relatively
    assert abs(total_g - float(total_j)) / abs(total_g) < 1e-4
    assert np.max(np.abs(acc_g.occ - np.asarray(acc_j.occ))) < 0.1
    rel = np.abs(acc_g.sx - np.asarray(acc_j.sx)) / (np.abs(acc_g.sx) + 1.0)
    assert rel.max() < 2e-2

    # end-to-end: Baum-Welch training decodes the training set exactly
    params_bw = trainer.train(task, feats_list, transcripts, iters=8, estep="bw")
    hyp = trainer.decode(task, params_bw, feats_list)
    scorer = WerScorer()
    for h, ref in zip(hyp, transcripts):
        scorer.add(ref, h)
    assert scorer.wer == 0.0
