"""Gates that need the card: the main path's numerics as the GPU computes
them (TF32 products, cuFFT, its own sort and top-k) against `golden/` and
against the decoders' own exact paths.  They skip without a GPU; run them
on one with the command in tests/conftest.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from golden import beamforming as gbf
from golden import features as gfe
from golden import filterbank as gfb
from golden import gmm_hmm as ggh
from golden import room as groom
from dsr.config import ArrayGeometry, FilterbankConfig
from dsr.ops import beamforming as jbf
from dsr.ops import features as jft
from dsr.ops import filterbank as jfb

pytestmark = pytest.mark.gpu

SR = 16000.0
CFG = FilterbankConfig(M=256, m=4, r=2)


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


def test_front_end_matches_golden(gpu):
    """Analysis, MVDR apply and synthesis on 16 channels x 2 s equal the
    float64 golden path; the MFCC of the output equals golden's."""
    N, S = 16, 32000
    POS = np.asarray(ArrayGeometry.circular(N, 0.10).positions)
    src = np.array([0.0, 2.0, 0.0])
    rng = np.random.default_rng(0)
    x = groom.simulate(rng.standard_normal(S), POS, src, SR, snr_db=20.0,
                       rng=rng).astype(np.float32)
    taus = groom.steering_delays(POS, src, 343.0, SR) / SR
    w_ref = gbf.mvdr_weights(gbf.steering_vectors(taus, CFG.M, SR),
                             gbf.diffuse_coherence(POS, CFG.M, SR, 343.0))
    hf, gf, delay = jfb.get_prototypes(CFG)
    A = jfb.analysis(jnp.asarray(x), CFG)
    w = jbf.mvdr_weights(
        jbf.steering_vectors(jnp.asarray(taus.astype(np.float32)), CFG.M, SR),
        jbf.diffuse_coherence(POS, CFG.M, SR, 343.0))
    Y = jbf.apply_weights(A, w)
    A_ref = np.stack([gfb.analysis(x[c].astype(np.float64), hf, CFG.M, CFG.r)
                      for c in range(N)])
    Y_ref = gbf.apply_weights(A_ref, w_ref)
    assert _rel(A, A_ref) < 1e-5
    assert _rel(Y, Y_ref) < 1e-3          # complex64 solve of a loaded Γ
    y = jfb.synthesis(Y, CFG, S)
    y_ref = gfb.synthesis(np.asarray(Y).astype(np.complex128), gf, CFG.M,
                          CFG.r, delay, S)
    assert _rel(y, y_ref) < 1e-5
    f = jft.mfcc_from_subbands(Y, CFG.M, SR)
    f_ref = gfe.mfcc_from_subbands(np.asarray(Y).astype(np.complex128),
                                   CFG.M, SR)
    assert float(np.max(np.abs(np.asarray(f) - f_ref))) < 1e-3


def test_gmm_loglik_matches_golden(gpu):
    """The mixture log-likelihood GEMM stays within 1e-3 of golden at
    |loglik| ~ 1e2 (TF32 would put ~5e-2 on it)."""
    rng = np.random.default_rng(1)
    S, C, D, T = 120, 2, 39, 500
    g = ggh.DiagGmm(rng.standard_normal((S, C, D)) * 2,
                    0.2 + rng.random((S, C, D)),
                    np.log(np.full((S, C), 1.0 / C)))
    feats = rng.standard_normal((T, D)) * 2
    from dsr.asr.am import gmm as jgmm

    ll = np.asarray(jgmm.loglik(jgmm.from_golden(g),
                                jnp.asarray(feats, jnp.float32)))
    assert float(np.max(np.abs(ll - g.loglik(feats)))) < 1e-3


def test_split_equals_dense_decode(gpu):
    """The degree-split decoder decodes the dense decoder's olabels and
    scores on the 43k-state trigram HCLG, as the card sorts them."""
    from dsr.asr import lvcsr
    from dsr.asr.decoder import split_decoder as sd
    from dsr.asr.decoder import topk_decoder as tk

    task = lvcsr.build_task(
        lvcsr.LvcsrConfig(vocab_size=300, n_tokens=5000, branching=3))
    rng = np.random.default_rng(2)
    ll = jnp.asarray(rng.standard_normal((4, 300, task.num_pdfs))
                     .astype(np.float32) * 2)
    lens = jnp.asarray([300, 280, 250, 300], jnp.int32)
    od, scd = tk.decode_batch(tk.build_token_graph(task.graph), ll, lens,
                              kcap=256, beam=40.0)
    os_, scs, ovf = sd.decode_batch_split(
        sd.build_split_graph(task.graph, a0=2), ll, lens, kcap=256,
        beam=40.0, eg=896)
    assert int(np.asarray(ovf).sum()) == 0
    assert np.array_equal(np.asarray(os_), np.asarray(od))
    assert float(np.max(np.abs(np.asarray(scs) - np.asarray(scd)))) < 1e-3
