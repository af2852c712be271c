"""fMLLR as CHANNEL adaptation — closing the loop on the round-5
mismatch diagnosis (PRUNING.md round 5): a tied-triphone AM trained on
CLEAN features collapses on reverberant-MVDR eval (93% WER vs the
matched-trained 8.7%) because the sharp context-dependent Gaussians sit
in the wrong place after the channel.  An affine feature transform is
exactly fMLLR's model of that shift, and the reference ships fMLLR for
this purpose (SURVEY §2.2 adapt row [K]).

Protocol (supervised enrollment, the standard recipe): train mono+tri on
clean audio → estimate ONE global fMLLR transform from A_UTTS
reverberant-MVDR enrollment utterances with known transcripts (forced
alignment under the clean AM → per-leaf posteriors → accumulate/estimate)
→ decode held-out MVDR eval utterances with vs without the transform on
the triphone distractor HCLG.

Gate: WER(tri, MVDR, fMLLR) < WER(tri, MVDR, unadapted).  The matched-
trained system (exp_tri_train.py) remains the production recipe; this
experiment shows the adaptation subsystem recovering a MISMATCHED system
the way the reference's workflow would.

Run: python tools/exp_fmllr_channel.py        (CPU ok)
Optional: NDIST=300 E_UTTS=12 A_UTTS=8 TRAIN_UTTS=60
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

NDIST = int(os.environ.get("NDIST", "300"))
E_UTTS = int(os.environ.get("E_UTTS", "12"))
A_UTTS = int(os.environ.get("A_UTTS", "8"))
TRAIN_UTTS = int(os.environ.get("TRAIN_UTTS", "60"))
KCAP = int(os.environ.get("KCAP", "512"))
BEAM = float(os.environ.get("BEAM", "80"))
SR = 16000.0
ROOM = np.array([5.0, 4.0, 3.0])
CENTER = np.array([2.0, 1.0, 1.2])
SRCPOS = np.array([0.6, 1.5, 0.3])


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from golden import corpus as gcorpus
    from golden import room as groom
    from dsr.asr import phone_task, triphone, tritrain
    from dsr.asr import path as apath
    from dsr.asr.adapt import fmllr
    from dsr.asr.am import gmm as jgmm
    from dsr.asr.decoder import topk_decoder as tk
    from dsr.asr.fsm import lm
    from dsr.asr.fsm.hclg import SymbolTable
    from dsr.asr.train import trainer
    from dsr.config import ArrayGeometry, FilterbankConfig
    from dsr.ops import beamforming as jbf
    from dsr.ops import features as jft
    from dsr.ops import filterbank as jfb
    from dsr.utils.metrics import WerScorer

    def feats_of(x):
        return np.asarray(jft.cmn(jft.mfcc(np.asarray(x, np.float32), SR)))

    t0 = time.time()
    # ---- clean-trained AMs (the MISMATCHED system) ---------------------
    task = phone_task.PhoneTask(gcorpus.VOCAB, states_per_phone=2)
    train_corpus = gcorpus.make_corpus(TRAIN_UTTS, seed=0)
    feats = [feats_of(x) for _, x in train_corpus]
    trans = [ws for ws, _ in train_corpus]
    mono = trainer.train(task, feats, trans, num_comp=2, iters=4)
    tri = tritrain.train_tied_triphone(task, mono, feats, trans, iters=3)
    print(f"[{time.time()-t0:.0f}s] clean-trained tri "
          f"({tri.tree.num_leaves} leaves)", flush=True)

    # ---- distractor triphone HCLG (exp_tri_train's graph) --------------
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
             for _ in range(4000)]
    G = lm.arpa_to_fst(lm.train_arpa_bigram(texts, vocab_all), words)
    nCLG, tbl, seen = triphone.build_clg_native(lexicon, task.phones,
                                                words, G)
    tri_graph, tstats = triphone.finish_tri_hclg_native(
        nCLG, tbl, tri.tree, task.phones, task.spp, seen_tris=seen)
    tg = tk.build_token_graph(tri_graph)
    print(f"[{time.time()-t0:.0f}s] tri HCLG {tstats}", flush=True)

    # ---- the production front-end --------------------------------------
    cfg = FilterbankConfig(M=256, m=4, r=2)
    POS = np.asarray(ArrayGeometry.circular(8, 0.10).positions)
    taus = (groom.steering_delays(POS, SRCPOS, 343.0, SR) / SR).astype(np.float32)
    v = jbf.steering_vectors(jnp.asarray(taus), cfg.M, SR)
    Gamma = jbf.diffuse_coherence(POS, cfg.M, SR, 343.0)
    w_mvdr = jbf.mvdr_weights(v, Gamma, 1e-2)
    simrng = np.random.default_rng(11)

    def mvdr_feats(x):
        xm = groom.simulate(x, POS, SRCPOS, SR, snr_db=30.0,
                            diffuse_snr_db=2.0, rng=simrng, room_dim=ROOM,
                            array_center=CENTER, reflect=0.75,
                            max_order=2).astype(np.float32)
        return feats_of(np.asarray(jfb.synthesis(
            jbf.apply_weights(jfb.analysis(xm, cfg), w_mvdr), cfg,
            xm.shape[-1])))

    # ---- enrollment: ONE global fMLLR from A_UTTS known utterances -----
    D = 13
    stats = None
    for ws, x in gcorpus.make_corpus(A_UTTS, seed=700):
        ft = jnp.asarray(mvdr_feats(x))
        al = apath.force_align(tri.task, tri.params, np.asarray(ft), ws)
        gamma = jax.nn.one_hot(al.states, tri.tree.num_leaves,
                               dtype=jnp.float32)
        s = fmllr.accumulate_fmllr(tri.params, ft, gamma)
        stats = s if stats is None else fmllr.FmllrStats(
            stats.G + s.G, stats.k + s.k, stats.beta + s.beta)
    Wf = fmllr.estimate_fmllr(stats)
    print(f"[{time.time()-t0:.0f}s] fMLLR estimated from {A_UTTS} "
          f"enrollment utts (beta={float(stats.beta):.0f})", flush=True)

    # ---- eval: unadapted vs adapted ------------------------------------
    sc_un, sc_ad = WerScorer(), WerScorer()
    for ref, x in gcorpus.make_corpus(E_UTTS, seed=300):
        ft = jnp.asarray(mvdr_feats(x))
        for Wt, sc in ((None, sc_un), (Wf, sc_ad)):
            f_in = ft if Wt is None else fmllr.apply_fmllr(ft, Wt)
            olabs, _ = tk.decode(tg, jgmm.loglik(tri.params, f_in),
                                 kcap=KCAP, beam=BEAM)
            sc.add(list(ref),
                   [words.name(int(w)) for w in np.asarray(olabs) if w])
        print(".", end="", flush=True)
    print(f"\n[{time.time()-t0:.0f}s] | system (clean-trained tri, MVDR "
          "eval) | WER% |")
    print("|---|---|")
    print(f"| unadapted | {100*sc_un.wer:.2f} |  ({sc_un})")
    print(f"| + global fMLLR | {100*sc_ad.wer:.2f} |  ({sc_ad})")
    ok = sc_ad.wer < sc_un.wer
    print(f"gate fMLLR-recovers-channel: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
