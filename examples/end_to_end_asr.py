"""End-to-end DSR demo: synthesize a corpus, train phone GMM-HMMs, build a
bigram HCLG, then beamform + decode noisy 8-channel eval audio and report
WER.  (BASELINE.json configs 1 + 4 at small scale; runs on CPU or GPU.)

    python examples/end_to_end_asr.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from golden import corpus as gcorpus
from golden import room as groom
from dsr.asr import phone_task
from dsr.asr.am import gmm as jgmm
from dsr.asr.decoder import wfst_decoder as wd
from dsr.asr.fsm import hclg, lm
from dsr.asr.fsm.packed import pack
from dsr.asr.train import trainer
from dsr.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr.ops import features as jft
from dsr.pipeline import DsrPipeline
from dsr.utils.metrics import RtfMeter, WerScorer

SR = 16000.0


def feats_of(x):
    return np.asarray(jft.cmn(jft.mfcc(np.asarray(x, np.float32), SR)))


def main():
    print("1) synthesizing training corpus + training phone GMM-HMMs ...")
    task = phone_task.PhoneTask(gcorpus.VOCAB, states_per_phone=2)
    train_corpus = gcorpus.make_corpus(60, seed=0)
    feats = [feats_of(x) for _, x in train_corpus]
    transcripts = [ws for ws, _ in train_corpus]
    params = trainer.train(task, feats, transcripts, num_comp=2, iters=4, verbose=True)

    print("2) building bigram HCLG ...")
    arpa = lm.train_arpa_bigram(transcripts, task.vocab)
    G = lm.arpa_to_fst(arpa, task.words)
    L, ndis = hclg.build_lexicon_fst(task.lexicon, task.phones, task.words, sil_phone="sil")
    H = hclg.build_hmm_fst(len(task.phones) - 1, ndis, states_per_phone=task.spp)
    HCLG = hclg.compose_hclg(H, L, G, len(task.phones) - 1, ndis)
    graph = wd.to_device(pack(HCLG))
    print(f"   HCLG: {pack(HCLG).num_states} states, {pack(HCLG).num_arcs} arcs")

    print("3) beamforming + decoding noisy 8-channel eval ...")
    pipe = DsrPipeline(
        fb=FilterbankConfig(M=256, m=4, r=2),
        geometry=ArrayGeometry.linear(8, 0.04),
        beamformer=BeamformerConfig(kind="mvdr"),
    )
    POS = np.asarray(pipe.geometry.positions)
    pos = np.array([0.4, 1.8, 0.2])
    rng = np.random.default_rng(7)
    sc = WerScorer()
    rtf = RtfMeter()
    for ref, x in gcorpus.make_corpus(8, seed=123):
        xm = groom.simulate(x, POS, pos, SR, snr_db=10.0, rng=rng).astype(np.float32)
        rtf.start()
        y, _ = pipe.process(xm, pos)
        f = feats_of(np.asarray(y))
        ll = jgmm.loglik(params, f)
        olabs, _, _ = wd.decode(graph, ll)
        rtf.stop(len(x) / SR)
        hyp = wd.words_from_olabels(np.asarray(olabs), task.words)
        sc.add(ref, hyp)
        print(f"   ref: {' '.join(ref):40s}  hyp: {' '.join(hyp)}")
    print(f"4) {sc}   |  {rtf.audio_sec_per_sec:.1f} audio-sec/s")


if __name__ == "__main__":
    main()
