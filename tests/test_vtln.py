"""VTLN warp-factor estimation gates (asr/adapt/vtln.py): a synthetically
warped speaker's factor is recovered by the ML grid search, and the warped
features improve the speaker's alignment likelihood (SURVEY.md §2.2
feature row; round-4 VERDICT missing #3)."""

import numpy as np
import pytest

from golden import corpus as gcorpus
from dsr.asr import phone_task
from dsr.asr.adapt import vtln
from dsr.asr.train import trainer
from dsr.ops import features as jft

SR = 16000.0
WARPS = (0.85, 0.9, 0.95, 1.0, 1.05, 1.1, 1.15)


def _feats(x):
    return np.asarray(jft.cmn(jft.mfcc(np.asarray(x, np.float32), SR)))


@pytest.fixture(scope="module")
def am():
    task = phone_task.PhoneTask(gcorpus.VOCAB, states_per_phone=2)
    corpus = gcorpus.make_corpus(25, seed=0)
    params = trainer.train(task, [_feats(x) for _, x in corpus],
                           [ws for ws, _ in corpus], num_comp=2, iters=3)
    return task, params


def _warped_corpus(n, scale, seed, monkeypatch):
    """Re-render the corpus with every formant frequency scaled by
    `scale` — a true vocal-tract-length change (durations untouched)."""
    warped = {p: tuple(f * scale for f in fs)
              for p, fs in gcorpus.PHONES.items()}
    monkeypatch.setattr(gcorpus, "PHONES", warped)
    try:
        return gcorpus.make_corpus(n, seed=seed)
    finally:
        monkeypatch.undo()


def test_unwarped_speaker_estimates_unity(am):
    task, params = am
    corpus = gcorpus.make_corpus(4, seed=200)
    best, scores = vtln.estimate_warp(
        task, params, [x for _, x in corpus], [ws for ws, _ in corpus],
        warps=WARPS)
    assert abs(best - 1.0) <= 0.05, scores


def test_warped_speaker_recovered_and_likelihood_improves(am, monkeypatch):
    task, params = am
    scale = 1.1          # formants 10% high → compensating warp ≈ 1/1.1
    corpus = _warped_corpus(4, scale, 200, monkeypatch)
    utts = [x for _, x in corpus]
    trans = [ws for ws, _ in corpus]
    best, scores = vtln.estimate_warp(task, params, utts, trans, warps=WARPS)
    assert abs(best - 1.0 / scale) <= 0.051, scores
    assert scores[best] > scores[1.0] + 1.0, scores
