"""NaN-guard mode (SURVEY.md §5 sanitizer analogue).

Runs the numeric core paths with `jax_debug_nans` enabled — any NaN
produced anywhere in these graphs raises immediately instead of
propagating silently.  `DSR_DEBUG_NANS=1` extends the guard to the whole
suite (see conftest.py).
"""

import numpy as np
import jax.numpy as jnp


def test_frontend_paths_nan_free(debug_nans):
    from dsr.config import ArrayGeometry, FilterbankConfig
    from dsr.ops import beamforming as jbf
    from dsr.ops import features as jft
    from dsr.ops import filterbank as jfb

    SR = 16000.0
    cfg = FilterbankConfig(M=64, m=2, r=2)
    geom = ArrayGeometry.circular(4, 0.1)
    POS = np.asarray(geom.positions)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 4000)).astype(np.float32)

    A = jfb.analysis(x, cfg)
    Gamma = jbf.diffuse_coherence(POS, cfg.M, SR, 343.0)
    taus = jnp.zeros(4, jnp.float32)
    v = jbf.steering_vectors(taus, cfg.M, SR)
    w = jbf.mvdr_weights(v, Gamma, 1e-2)
    Y = jbf.apply_weights(A, w)
    y = jfb.synthesis(Y, cfg, x.shape[-1])
    feats = jft.cmn(jft.mfcc_from_subbands(Y, cfg.M, SR))
    assert np.isfinite(np.asarray(y)).all()
    assert np.isfinite(np.asarray(feats)).all()

    # adaptive path: GSC-NLMS scan
    B = jbf.blocking_matrix(v)
    Yg, wa = jbf.gsc_nlms(A, jbf.ds_weights(v), B, mu=0.05)
    assert np.isfinite(np.abs(np.asarray(Yg))).all()


def test_train_decode_paths_nan_free(debug_nans):
    from dsr.asr import smallvocab
    from dsr.asr.am import gmm as jgmm
    from dsr.asr.train import trainer
    from golden import corpus as gcorpus
    from dsr.ops import features as jft
    from dsr.ops import filterbank as jfb
    from dsr.config import FilterbankConfig

    task = smallvocab.SmallVocabTask(gcorpus.VOCAB[:3])
    corpus = gcorpus.make_corpus(3, min_words=1, max_words=2, seed=0)
    cfg = FilterbankConfig(M=64, m=2, r=2)
    feats_list, transcripts = [], []
    for ws, x in corpus:
        ws = [w if w in task.vocab else task.vocab[0] for w in ws]
        A = jfb.analysis(np.asarray(x[:6000], np.float32), cfg)
        feats_list.append(np.asarray(jft.cmn(jft.mfcc_from_subbands(A, cfg.M, 16000.0))))
        transcripts.append(ws)
    params = trainer.train(task, feats_list, transcripts, num_comp=1, iters=1)
    assert np.isfinite(np.asarray(params.means)).all()
    hyps = trainer.decode(task, params, feats_list)
    assert len(hyps) == 3
