"""Tuning experiment for the reverberant beamforming-improves-WER gate
(tests/test_reverb_wer.py).  Trains the small-vocab model on clean speech,
then scores WER on image-source reverberant + diffuse-noise eval corpora
processed by: single mic, DS, superdirective MVDR, GSC, and WPE+DS.

Run: python tools/exp_reverb_wer.py [reflect] [snr] [dsnr]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
jax.config.update("jax_platforms", "cpu")

from golden import corpus as gcorpus
from golden import room as groom
from dsr.asr import smallvocab
from dsr.asr.train import trainer
from dsr.config import ArrayGeometry, FilterbankConfig
from dsr.ops import beamforming as jbf
from dsr.ops import dereverb as jdr
from dsr.ops import features as jft
from dsr.ops import filterbank as jfb
from dsr.utils.metrics import WerScorer

SR = 16000.0
ROOM = np.array([5.0, 4.0, 3.0])
CENTER = np.array([2.0, 1.0, 1.2])


def _mfcc_feats(x):
    f = jft.mfcc(np.asarray(x, np.float32), SR)
    return np.asarray(jft.cmn(f))


def main():
    reflect = float(sys.argv[1]) if len(sys.argv) > 1 else 0.75
    snr = float(sys.argv[2]) if len(sys.argv) > 2 else 30.0
    dsnr = float(sys.argv[3]) if len(sys.argv) > 3 else 2.0
    order = int(sys.argv[4]) if len(sys.argv) > 4 else 2
    n_eval = int(sys.argv[5]) if len(sys.argv) > 5 else 12

    t0 = time.time()
    train_corpus = gcorpus.make_corpus(60, seed=0)
    task = smallvocab.SmallVocabTask(gcorpus.VOCAB)
    feats = [_mfcc_feats(x) for _, x in train_corpus]
    transcripts = [ws for ws, _ in train_corpus]
    params = trainer.train(task, feats, transcripts, num_comp=2, iters=4)
    print(f"trained in {time.time()-t0:.1f}s")

    cfg = FilterbankConfig(M=256, m=4, r=2)
    N = 8
    POS = np.asarray(ArrayGeometry.circular(N, 0.10).positions)
    srcpos = np.array([0.6, 1.5, 0.3])
    taus = (groom.steering_delays(POS, srcpos, 343.0, SR) / SR).astype(np.float32)
    v = jbf.steering_vectors(taus, cfg.M, SR)
    w_ds = jbf.ds_weights(v)
    Gamma = jbf.diffuse_coherence(POS, cfg.M, SR, 343.0)
    w_mvdr = jbf.mvdr_weights(v, Gamma, 1e-2)
    B = jbf.blocking_matrix(v)

    eval_corpus = gcorpus.make_corpus(n_eval, seed=300)
    rng = np.random.default_rng(11)
    modes = ["single", "ds", "mvdr", "gsc", "wpe_ds"]
    scorers = {m: WerScorer() for m in modes}
    for ref_words, x in eval_corpus:
        xm = groom.simulate(
            x, POS, srcpos, SR, snr_db=snr, diffuse_snr_db=dsnr, rng=rng,
            room_dim=ROOM, array_center=CENTER, reflect=reflect,
            max_order=order,
        ).astype(np.float32)
        A = jfb.analysis(xm, cfg)                      # (N, T, K)
        outs = {}
        outs["single"] = xm[0]
        outs["ds"] = jfb.synthesis(jbf.apply_weights(A, w_ds), cfg, xm.shape[-1])
        outs["mvdr"] = jfb.synthesis(jbf.apply_weights(A, w_mvdr), cfg, xm.shape[-1])
        Yg, _ = jbf.gsc_nlms(A, w_mvdr, B, 0.05, 1e-6, 10.0, None)
        outs["gsc"] = jfb.synthesis(Yg, cfg, xm.shape[-1])
        Aw = jdr.wpe(A, taps=8, delay=2, iters=2)     # (N, T, K)
        outs["wpe_ds"] = jfb.synthesis(
            jbf.apply_weights(Aw, w_ds), cfg, xm.shape[-1])
        for m in modes:
            hyp = trainer.decode(task, params, [_mfcc_feats(outs[m])])[0]
            scorers[m].add(ref_words, hyp)
    print(f"reflect={reflect} order={order} snr={snr} diffuse={dsnr} "
          f"n={n_eval}  ({time.time()-t0:.1f}s)")
    for m in modes:
        print(f"  {m:8s} WER {scorers[m].wer:.3f}  {scorers[m]}")


if __name__ == "__main__":
    main()
