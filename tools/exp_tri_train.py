"""Round-5 VERDICT item 1 — the reference's ACTUAL workflow, end to end
with no synthetic stand-ins on the model side (SURVEY.md §3.4):

  MATCHED-front-end training audio (reverberant 8-ch sim → MVDR → MFCC)
  → monophone EM → forced alignment → DATA-driven tree stats
  → likelihood-gain tying → tied-triphone EM (asr/tritrain.py)
  → triphone HCLG over a large distractor lexicon (native WFST core)
  → reverberant 8-ch eval audio → MVDR beamforming → MFCC/CMN
  → degree-split PRODUCTION decode → WER.

MATCHED training is load-bearing (diagnosed round 5): AMs trained on
CLEAN features decode clean eval near-perfectly but collapse on
reverberant-MVDR eval (tri 93% WER vs mono 33% — the sharper
context-dependent Gaussians generalise WORSE across the channel
mismatch; dense kcap=2048 == split kcap=512 outputs ruled out search
width and the split path).  Training through the production front-end
is the standard distant-ASR recipe; TRAIN_FRONT=clean reproduces the
mismatch numbers.

Gates: WER(trained-tri, MVDR) < WER(trained-tri, single mic) — the
beamformer earns its keep under a TRAINED AM — and WER(trained-tri, MVDR)
<= WER(trained-mono, MVDR) — the tying earns its keep.  The committed
table lives in PRUNING.md (round-5 section).

Run: python tools/exp_tri_train.py        (CPU ok)
Optional: NDIST=300 E_UTTS=12 TRAIN_UTTS=60 TRAIN_FRONT=mvdr|clean
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

NDIST = int(os.environ.get("NDIST", "300"))
E_UTTS = int(os.environ.get("E_UTTS", "12"))
TRAIN_UTTS = int(os.environ.get("TRAIN_UTTS", "60"))
TRI_KCAP = int(os.environ.get("TRI_KCAP", "512"))
TRI_BEAM = float(os.environ.get("TRI_BEAM", "80"))
SR = 16000.0
ROOM = np.array([5.0, 4.0, 3.0])
CENTER = np.array([2.0, 1.0, 1.2])
SRCPOS = np.array([0.6, 1.5, 0.3])
REFLECT = 0.75
ORDER = 2
SNR_DB = 30.0
DIFFUSE_DB = 2.0
KCAP = 256


def big_lexicon(seed=0):
    from golden.corpus import PHONES, WORDS
    from golden import corpus as gcorpus

    rng = np.random.default_rng(seed)
    plist = sorted(PHONES)
    lexicon = {w: tuple(WORDS[w]) for w in gcorpus.VOCAB}
    for i in range(NDIST):
        n = int(rng.integers(2, 6))
        lexicon[f"w{i:04d}"] = tuple(
            plist[j] for j in rng.integers(0, len(plist), n))
    return lexicon, rng


def main():
    import jax
    if os.environ.get("BF_FULL") != "1":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from golden import corpus as gcorpus
    from golden import room as groom
    from dsr.asr import phone_task, triphone, tritrain
    from dsr.asr.am import gmm as jgmm
    from dsr.asr.decoder import split_decoder as sd
    from dsr.asr.decoder import topk_decoder as tk
    from dsr.asr.fsm import hclg, lm
    from dsr.asr.fsm.hclg import SymbolTable
    from dsr.asr.fsm.packed import pack
    from dsr.asr.train import trainer
    from dsr.config import ArrayGeometry, FilterbankConfig
    from dsr.ops import beamforming as jbf
    from dsr.ops import features as jft
    from dsr.ops import filterbank as jfb
    from dsr.utils.metrics import WerScorer

    def feats_of(x):
        return np.asarray(jft.cmn(jft.mfcc(np.asarray(x, np.float32), SR)))

    t0 = time.time()
    # ---- 0. the production front-end (used for training AND eval) ------
    cfg = FilterbankConfig(M=256, m=4, r=2)
    N = 8
    POS = np.asarray(ArrayGeometry.circular(N, 0.10).positions)
    taus = (groom.steering_delays(POS, SRCPOS, 343.0, SR) / SR).astype(np.float32)
    v = jbf.steering_vectors(jnp.asarray(taus), cfg.M, SR)
    Gamma = jbf.diffuse_coherence(POS, cfg.M, SR, 343.0)
    w_mvdr = jbf.mvdr_weights(v, Gamma, 1e-2)

    def mvdr_of(xm):
        A = jfb.analysis(xm, cfg)
        return np.asarray(jfb.synthesis(jbf.apply_weights(A, w_mvdr), cfg,
                                        xm.shape[-1]))

    # ---- 1. trained AMs from MATCHED-front-end audio -------------------
    task = phone_task.PhoneTask(gcorpus.VOCAB, states_per_phone=2)
    train_corpus = gcorpus.make_corpus(TRAIN_UTTS, seed=0)
    train_front = os.environ.get("TRAIN_FRONT", "mvdr")
    tsim = np.random.default_rng(23)
    if train_front == "mvdr":
        feats = []
        for _, x in train_corpus:
            xm = groom.simulate(x, POS, SRCPOS, SR, snr_db=SNR_DB,
                                diffuse_snr_db=DIFFUSE_DB, rng=tsim,
                                room_dim=ROOM, array_center=CENTER,
                                reflect=REFLECT, max_order=ORDER
                                ).astype(np.float32)
            feats.append(feats_of(mvdr_of(xm)))
    else:
        feats = [feats_of(x) for _, x in train_corpus]
    trans = [ws for ws, _ in train_corpus]
    mono = trainer.train(task, feats, trans, num_comp=2, iters=4)
    print(f"[{time.time()-t0:.0f}s] monophone trained", flush=True)
    tri = tritrain.train_tied_triphone(task, mono, feats, trans,
                                       iters=3, verbose=True)
    print(f"[{time.time()-t0:.0f}s] tied-triphone trained "
          f"({tri.stats_contexts} data contexts → {tri.tree.num_leaves} "
          "leaves)", flush=True)

    # ---- 2. decoding graphs over the distractor lexicon ----------------
    lexicon, rng = big_lexicon()
    vocab_all = sorted(lexicon)
    words = SymbolTable(vocab_all)
    texts = [[vocab_all[j] for j in rng.integers(0, len(vocab_all),
                                                 rng.integers(2, 6))]
             for _ in range(4000)]
    arpa = lm.train_arpa_bigram(texts, vocab_all)
    G = lm.arpa_to_fst(arpa, words)
    nCLG, tbl, seen = triphone.build_clg_native(lexicon, task.phones, words, G)
    tri_graph, tstats = triphone.finish_tri_hclg_native(
        nCLG, tbl, tri.tree, task.phones, task.spp, seen_tris=seen)
    sg = sd.build_split_graph(tri_graph)
    print(f"[{time.time()-t0:.0f}s] tri HCLG: {tstats} "
          f"groups={sg.num_groups}", flush=True)
    L, ndis = hclg.build_lexicon_fst(lexicon, task.phones, words,
                                     sil_phone="sil")
    Hm = hclg.build_hmm_fst(len(task.phones) - 1, ndis,
                            states_per_phone=task.spp)
    mono_graph = pack(hclg.compose_hclg(Hm, L, G, len(task.phones) - 1, ndis))
    tg_m = tk.build_token_graph(mono_graph)
    print(f"[{time.time()-t0:.0f}s] mono HCLG: {mono_graph.num_states} "
          f"states {len(mono_graph.src)} arcs a_max={tg_m.a_max}", flush=True)

    # ---- 3. reverberant eval → beamform → decode -----------------------
    simrng = np.random.default_rng(11)
    eval_corpus = gcorpus.make_corpus(E_UTTS, seed=300)
    fronts = ["single", "mvdr"]
    systems = ["mono", "tri"]
    sc = {(s, f): WerScorer() for s in systems for f in fronts}
    kcap_tri = min(TRI_KCAP, sg.num_states)
    # overflow budget: max_outdeg=212 → one word-end token wants 26
    # groups; the 256 default silently dropped arcs at word boundaries
    # (exactly where olabels live) and cost the tri system ~40% WER
    eg_tri = int(os.environ.get("TRI_EG", "2048"))
    tot_ovf = 0
    for ref_words, x in eval_corpus:
        xm = groom.simulate(x, POS, SRCPOS, SR, snr_db=SNR_DB,
                            diffuse_snr_db=DIFFUSE_DB, rng=simrng,
                            room_dim=ROOM, array_center=CENTER,
                            reflect=REFLECT, max_order=ORDER).astype(np.float32)
        outs = {"single": xm[0], "mvdr": mvdr_of(xm)}
        for f in fronts:
            ft = jnp.asarray(feats_of(outs[f]))
            # production path: degree-split decoder, trained tri AM
            ll_t = jgmm.loglik(tri.params, ft)
            olabs, _, ovf = sd.decode_split(
                sg, ll_t, kcap=kcap_tri, beam=TRI_BEAM, eg=eg_tri)
            tot_ovf += int(ovf)
            hyp_t = [words.name(int(wd)) for wd in np.asarray(olabs) if wd]
            sc[("tri", f)].add(list(ref_words), hyp_t)
            ll_m = jgmm.loglik(mono, ft)
            olabs_m, _ = tk.decode(tg_m, ll_m, kcap=KCAP, beam=60.0)
            hyp_m = [words.name(int(wd)) for wd in np.asarray(olabs_m) if wd]
            sc[("mono", f)].add(list(ref_words), hyp_m)
        print(".", end="", flush=True)

    print(f"\n[{time.time()-t0:.0f}s] | AM (trained from audio) | front-end "
          f"| WER% ({tstats['num_states']}-state tri / "
          f"{mono_graph.num_states}-state mono HCLG, "
          f"{len(words)}-word vocab) |")
    print("|---|---|---|")
    for s in systems:
        for f in fronts:
            print(f"| {s} | {f} | {100 * sc[(s, f)].wer:.2f} |  ({sc[(s, f)]})")
    print(f"split-decode certificate: overflow_frames={tot_ovf} "
          f"(eg={eg_tri})")
    wer = {k: v.wer for k, v in sc.items()}
    ok1 = wer[("tri", "mvdr")] < wer[("tri", "single")]
    ok2 = wer[("tri", "mvdr")] <= wer[("mono", "mvdr")] + 1e-9
    print(f"gate beamforming-wins (tri): {'PASS' if ok1 else 'FAIL'}; "
          f"gate tying-wins-or-matches (mvdr): {'PASS' if ok2 else 'FAIL'}")
    return 0 if (ok1 and ok2) else 1


if __name__ == "__main__":
    raise SystemExit(main())
