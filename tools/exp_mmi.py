"""MMI earns its keep (round-4 VERDICT weak #2 / item 5): EBW iterations
strictly increase the MMI criterion, and discriminative training converts
to WER at a noise point where the ML system makes errors.

Pipeline: ML-train the monophone GMM AM on MATCHED-noise synthetic audio
(multi-condition training — the discriminative-training recipe needs the
denominator statistics collected under the eval condition) → EBW
(numerator = forced alignments, denominator = exact forward-backward over
the bigram decode HCLG, asr/train/mmi.ebw_train) → decode noisy eval
audio with the ML vs the MMI AM on the same graph.

Run: python tools/exp_mmi.py        (CPU ok)
Optional: NOISE=0.12 TRAIN_NOISE=0.12 E_UTTS=24 ITERS=4 ECONST=2.0
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

NOISE = float(os.environ.get("NOISE", "0.12"))
TRAIN_NOISE = float(os.environ.get("TRAIN_NOISE", str(NOISE)))
E_UTTS = int(os.environ.get("E_UTTS", "24"))
ITERS = int(os.environ.get("ITERS", "4"))
ECONST = float(os.environ.get("ECONST", "2.0"))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from golden import corpus as gcorpus
    from dsr.asr import phone_task
    from dsr.asr.am import gmm as jgmm
    from dsr.asr.decoder import wfst_decoder as wd
    from dsr.asr.fsm import hclg, lm
    from dsr.asr.fsm.packed import pack
    from dsr.asr.train import mmi, trainer
    from dsr.ops import features as jft
    from dsr.utils.metrics import WerScorer

    SR = 16000.0

    def feats_of(x):
        return np.asarray(jft.cmn(jft.mfcc(np.asarray(x, np.float32), SR)))

    t0 = time.time()
    task = phone_task.PhoneTask(gcorpus.VOCAB, states_per_phone=2)
    corpus = gcorpus.make_corpus(60, seed=0)
    trng = np.random.default_rng(3)
    feats = [feats_of(np.asarray(x)
                      + TRAIN_NOISE * trng.standard_normal(len(x)))
             for _, x in corpus]
    trans = [ws for ws, _ in corpus]
    ml_params = trainer.train(task, feats, trans, num_comp=2, iters=4)
    print(f"[{time.time()-t0:.0f}s] ML AM trained", flush=True)

    arpa = lm.train_arpa_bigram(trans, task.vocab)
    G = lm.arpa_to_fst(arpa, task.words)
    L, ndis = hclg.build_lexicon_fst(task.lexicon, task.phones, task.words,
                                     sil_phone="sil")
    H = hclg.build_hmm_fst(len(task.phones) - 1, ndis,
                           states_per_phone=task.spp)
    graph = pack(hclg.compose_hclg(H, L, G, len(task.phones) - 1, ndis))
    dev = wd.to_device(graph)
    print(f"[{time.time()-t0:.0f}s] HCLG {graph.num_states} states", flush=True)

    mmi_params, hist = mmi.ebw_train(task, ml_params, dev, feats, trans,
                                     iters=ITERS, e_const=ECONST,
                                     verbose=True)
    print(f"[{time.time()-t0:.0f}s] EBW criterion history: "
          f"{[round(h, 1) for h in hist]}")
    deltas = np.diff(hist)
    print(f"strictly-increasing gate: "
          f"{'PASS' if bool((deltas > 0).all()) else 'FAIL'} "
          f"(min step {deltas.min():.2f})")

    rng = np.random.default_rng(7)
    sc_ml, sc_mmi = WerScorer(), WerScorer()
    for ref, x in gcorpus.make_corpus(E_UTTS, seed=500):
        xn = np.asarray(x) + NOISE * rng.standard_normal(len(x))
        f = jnp.asarray(feats_of(xn))
        for params, sc in ((ml_params, sc_ml), (mmi_params, sc_mmi)):
            olabs, _, _ = wd.decode(dev, np.asarray(jgmm.loglik(params, f)))
            sc.add(list(ref), wd.words_from_olabels(np.asarray(olabs),
                                                    task.words))
    print(f"\n| AM | WER% (noise {NOISE}, {E_UTTS} utts) |")
    print("|---|---|")
    print(f"| ML  | {100*sc_ml.wer:.2f} |  ({sc_ml})")
    print(f"| MMI | {100*sc_mmi.wer:.2f} |  ({sc_mmi})")
    ok = sc_mmi.wer <= sc_ml.wer
    print(f"gate WER(MMI) <= WER(ML): {'PASS' if ok else 'FAIL'}")
    return 0 if ok and bool((deltas > 0).all()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
