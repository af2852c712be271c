"""Configs 2+4 chained (round-4 VERDICT item 8): beamforming must win
WER when the decode searches a LARGE-vocabulary HCLG built from audio-
synthesisable words + random-phone distractors (PRUNING.md round-4
"beamformed-input large-vocabulary decode": at 600 distractors MVDR
recovers 35% absolute over the single mic; this gate runs the same chain
at 150 distractors)."""

import numpy as np
import jax.numpy as jnp
import pytest

from golden import corpus as gcorpus
from golden import room as groom
from dsr.asr import phone_task
from dsr.asr.am import gmm as jgmm
from dsr.asr.decoder import topk_decoder as tk
from dsr.asr.train import trainer
from dsr.config import ArrayGeometry, FilterbankConfig
from dsr.ops import beamforming as jbf
from dsr.ops import features as jft
from dsr.ops import filterbank as jfb
from dsr.utils.metrics import WerScorer
import tools.exp_bf_lvcsr as ebf

SR = 16000.0


def _feats(x):
    return np.asarray(jft.cmn(jft.mfcc(np.asarray(x, np.float32), SR)))


def test_beamforming_wins_wer_at_large_vocab_graph():
    ebf.NDIST = 150
    graph, words, phones = ebf.build_big_graph(seed=0)
    tg = tk.build_token_graph(graph)
    assert graph.num_states > 1000 and len(graph.src) > 50_000, (
        graph.num_states, len(graph.src))

    task = phone_task.PhoneTask(gcorpus.VOCAB, states_per_phone=2)
    train_corpus = gcorpus.make_corpus(60, seed=0)
    params = trainer.train(task, [_feats(x) for _, x in train_corpus],
                           [ws for ws, _ in train_corpus], num_comp=2,
                           iters=4)

    cfg = FilterbankConfig(M=256, m=4, r=2)
    POS = np.asarray(ArrayGeometry.circular(8, 0.10).positions)
    taus = (groom.steering_delays(POS, ebf.SRCPOS, 343.0, SR) / SR
            ).astype(np.float32)
    v = jbf.steering_vectors(jnp.asarray(taus), cfg.M, SR)
    Gamma = jbf.diffuse_coherence(POS, cfg.M, SR, 343.0)
    w_mvdr = jbf.mvdr_weights(v, Gamma, 1e-2)

    rng = np.random.default_rng(11)
    eval_corpus = gcorpus.make_corpus(8, seed=300)
    sc = {m: WerScorer() for m in ("single", "mvdr")}
    for ref_words, x in eval_corpus:
        xm = groom.simulate(
            x, POS, ebf.SRCPOS, SR, snr_db=ebf.SNR_DB,
            diffuse_snr_db=ebf.DIFFUSE_DB, rng=rng, room_dim=ebf.ROOM,
            array_center=ebf.CENTER, reflect=ebf.REFLECT,
            max_order=ebf.ORDER).astype(np.float32)
        A = jfb.analysis(xm, cfg)
        outs = {"single": xm[0],
                "mvdr": jfb.synthesis(jbf.apply_weights(A, w_mvdr), cfg,
                                      xm.shape[-1])}
        for m in sc:
            ll = jgmm.loglik(params, jnp.asarray(_feats(outs[m])))
            olabs, _ = tk.decode(tg, ll, kcap=256, beam=60.0)
            hyp = [words.name(int(wd)) for wd in np.asarray(olabs) if wd]
            sc[m].add(list(ref_words), hyp)

    detail = {m: str(sc[m]) for m in sc}
    # measured draws: MVDR 35.3% vs single 44.1% (N=34 words)
    assert sc["mvdr"].wer <= sc["single"].wer - 0.05, detail
