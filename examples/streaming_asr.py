"""Streaming recognition demo: multi-channel audio arrives in ragged
chunks; the StreamingRecognizer carries frontend / beamformer / decoder
state across them and emits the SAME words as offline decoding
(SURVEY.md §5 long-context story, through the decoder).

    python examples/streaming_asr.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from golden import corpus as gcorpus
from golden import room as groom
from dsr.asr import phone_task
from dsr.asr.am import gmm as jgmm
from dsr.asr.decoder import topk_decoder as tk
from dsr.asr.fsm import hclg, lm
from dsr.asr.fsm.packed import pack
from dsr.asr.train import trainer
from dsr.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr.ops import features as jft
from dsr.ops import filterbank as jfb
from dsr.pipeline import DsrPipeline, StreamingRecognizer

SR = 16000.0


def main():
    # ---- train a small phone GMM-HMM + bigram HCLG (config 1) -----------
    task = phone_task.PhoneTask(gcorpus.VOCAB[:6], states_per_phone=2)
    fb = FilterbankConfig(M=64, m=2, r=2)
    train_corpus = gcorpus.make_corpus(30, seed=0)
    feats, transcripts = [], []
    for ws, x in train_corpus:
        ws = [w if w in task.vocab else task.vocab[0] for w in ws]
        A = jfb.analysis(np.asarray(x, np.float32), fb)
        feats.append(np.asarray(jft.cmn(jft.mfcc_from_subbands(A, fb.M, SR))))
        transcripts.append(ws)
    params = trainer.train(task, feats, transcripts, num_comp=2, iters=3)
    arpa = lm.train_arpa_bigram(transcripts, task.vocab)
    G = lm.arpa_to_fst(arpa, task.words)
    L, ndis = hclg.build_lexicon_fst(task.lexicon, task.phones, task.words,
                                     sil_phone="sil")
    H = hclg.build_hmm_fst(len(task.phones) - 1, ndis, states_per_phone=task.spp)
    tg = tk.build_token_graph(pack(hclg.compose_hclg(H, L, G,
                                                     len(task.phones) - 1, ndis)))

    # ---- an eval utterance rendered onto a 4-mic array -------------------
    geom = ArrayGeometry.linear(4, 0.05)
    pipe = DsrPipeline(fb=fb, geometry=geom,
                       beamformer=BeamformerConfig(kind="ds"))
    ref_words, x = gcorpus.make_corpus(1, min_words=3, max_words=4, seed=42)[0]
    ref_words = [w if w in task.vocab else task.vocab[0] for w in ref_words]
    src_pos = np.array([0.4, 1.2, 0.0])
    xm = groom.simulate(np.asarray(x, np.float32),
                        np.asarray(geom.positions), src_pos, SR, snr_db=25.0,
                        rng=np.random.default_rng(7)).astype(np.float32)

    # fixed cepstral mean (streaming CMN is not causal; production systems
    # use a precomputed mean) — here from the training data
    cep_mean = np.mean(np.concatenate(feats), axis=0)

    # ---- offline reference ------------------------------------------------
    A = jfb.analysis(jnp.asarray(xm), pipe.fb)
    Y, _ = pipe.beamform_subbands(A, src_pos)
    f_off = jft.mfcc_from_subbands(Y, pipe.fb.M, SR) - cep_mean
    olabs, _ = tk.decode(tg, jgmm.loglik(params, f_off), kcap=128)
    words_off = [task.words.name(int(w)) for w in np.asarray(olabs) if w]

    # ---- streamed: ragged chunks through the full chain -------------------
    rng = np.random.default_rng(1)
    cuts = np.sort(rng.choice(np.arange(400, xm.shape[-1] - 400), 6, replace=False))
    bounds = [0, *map(int, cuts), xm.shape[-1]]
    chunks = [xm[:, bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]
    rec = StreamingRecognizer(pipe, lambda f: jgmm.loglik(params, f), tg,
                              src_pos, kcap=128, cep_mean=cep_mean)
    words_ids, score = rec.run(chunks)
    words_s = [task.words.name(w) for w in words_ids]

    print(f"reference : {' '.join(ref_words)}")
    print(f"offline   : {' '.join(words_off)}")
    print(f"streamed  : {' '.join(words_s)}  (chunks: "
          f"{[c.shape[-1] for c in chunks]})")
    assert words_s == words_off, "streamed decode must equal offline"
    print(f"streamed == offline ✓  (score {score:.1f})")


if __name__ == "__main__":
    main()
