"""Configs 2+4 chained (round-4 VERDICT item 5/8): reverberant
multi-channel AUDIO → beamforming → features → LARGE-VOCABULARY HCLG
decode → WER.

Round 3's WER evidence split into beamforming→WER at small vocab and
LVCSR WER on directly synthesized features; this experiment closes the
chain: the 10 real (audio-synthesisable) words are embedded in a
large-vocabulary lexicon of NDIST random-phone-string distractor words
with a bigram LM over the full vocabulary, so the decoder must pick the
spoken words out of an LVCSR-scale search space from BEAMFORMED audio.
WER(single mic) vs WER(MVDR) vs WER(GSC) at the full graph.

Run: python tools/exp_bf_lvcsr.py        (CPU ok)
Optional: NDIST=600 E_UTTS=12
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

NDIST = int(os.environ.get("NDIST", "600"))
E_UTTS = int(os.environ.get("E_UTTS", "12"))
SR = 16000.0
ROOM = np.array([5.0, 4.0, 3.0])
CENTER = np.array([2.0, 1.0, 1.2])
SRCPOS = np.array([0.6, 1.5, 0.3])
REFLECT = 0.75
ORDER = 2
SNR_DB = 30.0
DIFFUSE_DB = 2.0


def build_big_graph(seed=0):
    """10 real words + NDIST random-phone distractors → packed HCLG +
    the word SymbolTable (pdf ids match PhoneTask's GMM numbering)."""
    from golden.corpus import PHONES, WORDS
    from golden import corpus as gcorpus
    from dsr.asr.fsm import hclg, lm
    from dsr.asr.fsm.hclg import SymbolTable
    from dsr.asr.fsm.packed import pack

    rng = np.random.default_rng(seed)
    plist = sorted(PHONES)
    lexicon = {w: tuple(WORDS[w]) for w in gcorpus.VOCAB}
    for i in range(NDIST):
        n = int(rng.integers(2, 6))
        lexicon[f"w{i:04d}"] = tuple(
            plist[j] for j in rng.integers(0, len(plist), n))
    vocab_all = sorted(lexicon)
    words = SymbolTable(vocab_all)
    phones = SymbolTable(["sil"] + plist)
    # bigram LM text: random sentences over the FULL vocabulary (the real
    # words appear at natural 10/(10+NDIST) rate — no prior advantage)
    texts = [[vocab_all[j] for j in rng.integers(0, len(vocab_all),
                                                 rng.integers(2, 6))]
             for _ in range(4000)]
    arpa = lm.train_arpa_bigram(texts, vocab_all)
    G = lm.arpa_to_fst(arpa, words)
    L, ndis = hclg.build_lexicon_fst(lexicon, phones, words, sil_phone="sil")
    H = hclg.build_hmm_fst(len(phones) - 1, ndis, states_per_phone=2)
    HCLG = hclg.compose_hclg(H, L, G, len(phones) - 1, ndis)
    return pack(HCLG), words, phones


def main():
    import jax
    if os.environ.get("BF_FULL") != "1":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

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

    def feats_of(x):
        return np.asarray(jft.cmn(jft.mfcc(np.asarray(x, np.float32), SR)))

    # AM: GMM over the monophone pdf set, trained on clean audio
    task = phone_task.PhoneTask(gcorpus.VOCAB, states_per_phone=2)
    train_corpus = gcorpus.make_corpus(60, seed=0)
    params = trainer.train(task, [feats_of(x) for _, x in train_corpus],
                           [ws for ws, _ in train_corpus], num_comp=2,
                           iters=4)
    print("AM trained", flush=True)

    graph, words, phones = build_big_graph()
    tg = tk.build_token_graph(graph)
    print(f"big-vocab HCLG: {graph.num_states} states, "
          f"{len(graph.src)} arcs, a_max={tg.a_max}, "
          f"vocab {len(words)} words", flush=True)

    cfg = FilterbankConfig(M=256, m=4, r=2)
    N = 8
    POS = np.asarray(ArrayGeometry.circular(N, 0.10).positions)
    taus = (groom.steering_delays(POS, SRCPOS, 343.0, SR) / SR).astype(np.float32)
    v = jbf.steering_vectors(jnp.asarray(taus), cfg.M, SR)
    Gamma = jbf.diffuse_coherence(POS, cfg.M, SR, 343.0)
    w_mvdr = jbf.mvdr_weights(v, Gamma, 1e-2)
    B = jbf.blocking_matrix(v)

    rng = np.random.default_rng(11)
    eval_corpus = gcorpus.make_corpus(E_UTTS, seed=300)
    modes = ["single", "mvdr", "gsc"]
    sc = {m: WerScorer() for m in modes}
    for ref_words, x in eval_corpus:
        xm = groom.simulate(x, POS, SRCPOS, SR, snr_db=SNR_DB,
                            diffuse_snr_db=DIFFUSE_DB, rng=rng,
                            room_dim=ROOM, array_center=CENTER,
                            reflect=REFLECT, max_order=ORDER).astype(np.float32)
        A = jfb.analysis(xm, cfg)
        outs = {"single": xm[0],
                "mvdr": jfb.synthesis(jbf.apply_weights(A, w_mvdr), cfg,
                                      xm.shape[-1])}
        Yg, _ = jbf.gsc_nlms(A, w_mvdr, B, 0.05, 1e-6, 10.0, None)
        outs["gsc"] = jfb.synthesis(Yg, cfg, xm.shape[-1])
        for m in modes:
            ll = jgmm.loglik(params, jnp.asarray(feats_of(outs[m])))
            olabs, _ = tk.decode(tg, ll, kcap=256, beam=60.0)
            hyp = [words.name(int(wd)) for wd in np.asarray(olabs) if wd]
            sc[m].add(list(ref_words), hyp)

    print(f"\n| front-end | WER% ({graph.num_states}-state "
          f"{len(words)}-word HCLG) |")
    print("|---|---|")
    for m in modes:
        print(f"| {m} | {100 * sc[m].wer:.2f} |  ({sc[m]})")


if __name__ == "__main__":
    main()
