"""Parity gates for the front end's XLA paths at the D=128 configuration
the benchmark runs (filterbank analysis and synthesis, beamform apply,
GSC-NLMS, forced alignment) against the NumPy references in `golden/`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from golden import beamforming as gbf
from golden import filterbank as gfb
from golden import room as groom
from dsr.config import ArrayGeometry, FilterbankConfig
from dsr.ops import beamforming as jbf
from dsr.ops import filterbank as jfb

SR = 16000.0
CFG = FilterbankConfig(M=256, m=4, r=2)  # D=128: the benchmark's config


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


def test_analysis_matches_xla():
    x = np.random.default_rng(0).standard_normal((2, 20000)).astype(np.float32)
    hf = jfb.get_prototypes(CFG)[0]
    A = np.asarray(jfb.analysis(x, CFG))
    for c in range(2):
        ref = gfb.analysis(x[c].astype(np.float64), hf, CFG.M, CFG.r)
        assert A[c].shape == ref.shape
        assert _rel(A[c], ref) < 1e-5


def test_synthesis_matches_xla_and_reconstructs():
    x = np.random.default_rng(1).standard_normal(20000).astype(np.float32)
    _, gf, delay = jfb.get_prototypes(CFG)
    A = jfb.analysis(x, CFG)
    y = np.asarray(jfb.synthesis(A, CFG, len(x)))
    ref = gfb.synthesis(np.asarray(A).astype(np.complex128), gf, CFG.M,
                        CFG.r, delay, len(x))
    assert _rel(y, ref) < 1e-5
    err_db = 20 * np.log10(np.max(np.abs(y - x)) / np.max(np.abs(x)))
    assert err_db < -50.0


@pytest.mark.parametrize("lead,T,mr,D", [
    ((), 1, 4, 8),           # a single frame: output is that frame
    ((), 7, 1, 16),          # mr = 1: no overlap at all
    ((), 9, 8, 128),         # the benchmark's m·r = 8, D = 128
    ((3,), 5, 4, 32),        # batched leading axis
    ((2, 2), 6, 2, 4),       # two leading axes
])
def test_overlap_add_matches_scatter(lead, T, mr, D):
    """The shifted-slice overlap-add equals the scatter-add it replaces:
    sample i of frame t lands at t·D + i."""
    w = np.random.default_rng(T * mr).standard_normal(
        lead + (T, mr * D)).astype(np.float32)
    y = np.asarray(jfb.overlap_add_frames(
        jnp.asarray(w).reshape(lead + (T, mr, D))))
    ref = np.zeros(lead + ((T - 1) * D + mr * D,), np.float64)
    for t in range(T):
        ref[..., t * D:t * D + mr * D] += w[..., t, :]
    assert y.shape == ref.shape
    np.testing.assert_allclose(y, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M,m,r", [(64, 2, 2), (64, 4, 2), (96, 2, 2)])
def test_synthesis_matches_golden_other_configs(M, m, r):
    """Synthesis equals the golden loop at configs with other block
    counts m·r (the overlap-add depth) than the benchmark's."""
    cfg = FilterbankConfig(M=M, m=m, r=r)
    x = np.random.default_rng(M + m + r).standard_normal(3000).astype(np.float32)
    _, gf, delay = jfb.get_prototypes(cfg)
    A = jfb.analysis(x, cfg)
    y = np.asarray(jfb.synthesis(A, cfg, len(x)))
    ref = gfb.synthesis(np.asarray(A).astype(np.complex128), gf, M, r,
                        delay, len(x))
    assert _rel(y, ref) < 1e-5


def _mvdr_weights(N, radius, src):
    POS = np.asarray(ArrayGeometry.circular(N, radius).positions)
    taus = (groom.steering_delays(POS, np.array(src), 343.0, SR) / SR).astype(
        np.float32)
    Gamma = jbf.diffuse_coherence(POS, CFG.M, SR, 343.0)
    return jbf.mvdr_weights(jbf.steering_vectors(jnp.asarray(taus), CFG.M, SR),
                            Gamma)


def test_fused_analysis_beamform_matches_unfused():
    """apply_weights(analysis(x), w) for MVDR weights equals the golden
    analysis and apply on a 313-frame signal."""
    N = 6
    w = _mvdr_weights(N, 0.10, [0.0, 2.0, 0.0])
    hf = jfb.get_prototypes(CFG)[0]
    x = np.random.default_rng(7).standard_normal((N, 40960)).astype(np.float32)
    Y = np.asarray(jbf.apply_weights(jfb.analysis(x, CFG), w))
    X_ref = np.stack([gfb.analysis(x[c].astype(np.float64), hf, CFG.M, CFG.r)
                      for c in range(N)])
    Y_ref = gbf.apply_weights(X_ref, np.asarray(w).astype(np.complex128))
    assert Y.shape == Y_ref.shape
    assert _rel(Y, Y_ref) < 1e-5


def test_fused_analysis_beamform_staged_bank():
    """A bank of buffers analysed and beamformed in one batched call
    equals each buffer on its own and the golden reference."""
    N, S = 4, 20000
    POS = np.asarray(ArrayGeometry.circular(N, 0.08).positions)
    taus = (groom.steering_delays(POS, np.array([1.0, 1.5, 0.0]), 343.0, SR)
            / SR).astype(np.float32)
    w = jbf.ds_weights(jbf.steering_vectors(jnp.asarray(taus), CFG.M, SR))
    hf = jfb.get_prototypes(CFG)[0]
    xs = np.random.default_rng(8).standard_normal((3, N, S)).astype(np.float32)
    Yb = np.asarray(jbf.apply_weights(jfb.analysis(xs, CFG), w))
    for b in (0, 2):
        Y1 = np.asarray(jbf.apply_weights(jfb.analysis(xs[b], CFG), w))
        np.testing.assert_allclose(Yb[b], Y1, rtol=1e-6, atol=1e-6)
        X_ref = np.stack([gfb.analysis(xs[b, c].astype(np.float64), hf,
                                       CFG.M, CFG.r) for c in range(N)])
        Y_ref = gbf.apply_weights(X_ref, np.asarray(w).astype(np.complex128))
        assert _rel(Yb[b], Y_ref) < 1e-5


def _gsc_problem(seed, src_x, T):
    M = 64
    POS = np.asarray(ArrayGeometry.linear(4, 0.04).positions)
    rng = np.random.default_rng(seed)
    N, K = 4, M // 2 + 1
    taus = groom.steering_delays(POS, np.array([src_x, 1.0, 0.0]), 343.0, SR) / SR
    vd = jbf.steering_vectors(taus.astype(np.float32), M, SR)
    wq = np.asarray(vd) / N
    B = np.asarray(jbf.blocking_matrix(vd))
    X = (rng.standard_normal((N, T, K)) + 1j * rng.standard_normal((N, T, K))
         ).astype(np.complex64)
    return X, wq, B


def test_gsc_kernel_matches_scan():
    T = 40
    X, wq, B = _gsc_problem(2, 0.0, T)
    Y_ref, wa_ref = gbf.gsc_nlms(X.astype(np.complex128), wq, B, mu=0.1)
    Xd, wqd, Bd = jnp.asarray(X), jnp.asarray(wq), jnp.asarray(B)
    Y, wa = jbf.gsc_nlms(Xd, wqd, Bd, mu=0.1)
    Y, wa = np.asarray(Y), np.asarray(wa)
    assert _rel(Y, Y_ref) < 1e-5
    assert np.max(np.abs(wa - wa_ref)) < 1e-5
    # wa0 threading: the second half seeded with the first half's weights
    # == one full pass
    Y1, wa1 = jbf.gsc_nlms(Xd[:, : T // 2], wqd, Bd, mu=0.1)
    Y2, wa2 = jbf.gsc_nlms(Xd[:, T // 2:], wqd, Bd, mu=0.1, wa0=wa1)
    assert np.max(np.abs(np.concatenate([np.asarray(Y1), np.asarray(Y2)])
                         - Y)) < 1e-5
    assert np.max(np.abs(np.asarray(wa2) - wa)) < 1e-5


def test_banded_viterbi_kernel_matches_dense():
    """Forced-alignment Viterbi on a left-to-right chain equals the golden
    dense recursion."""
    from golden import gmm_hmm as ggh
    from dsr.asr.decoder import viterbi as jvit

    rng = np.random.default_rng(5)
    T, S = 60, 37
    ll = rng.standard_normal((T, S))
    A = np.full((S, S), -1e30)
    np.fill_diagonal(A, np.log(0.6))
    for s in range(S - 1):
        A[s, s + 1] = np.log(0.4)
    init = np.full(S, -1e30)
    init[0] = 0.0
    final = np.full(S, -1e30)
    final[S - 1] = 0.0
    p_ref, s_ref = ggh.viterbi_dense(ll, A, init, final)
    path, score = jvit.viterbi(*(jnp.asarray(a, jnp.float32)
                                 for a in (ll, A, init, final)))
    assert abs(float(score) - s_ref) < 1e-2
    np.testing.assert_array_equal(np.asarray(path), p_ref)


def test_gsc_kernel_batched_matches_scan():
    """Batched utterances (per-utterance steering) adapt independently
    under one vmapped call."""
    probs = [_gsc_problem(9 + b, 0.3 * b - 0.3, 30) for b in range(3)]
    Xs, wqs, Bs = (np.stack(p) for p in zip(*probs))
    Y = np.asarray(jax.vmap(lambda x, q, b: jbf.gsc_nlms(x, q, b, mu=0.1)[0])(
        jnp.asarray(Xs), jnp.asarray(wqs), jnp.asarray(Bs)))
    ref = np.stack([gbf.gsc_nlms(x.astype(np.complex128), q, b, mu=0.1)[0]
                    for x, q, b in probs])
    assert Y.shape == ref.shape
    assert _rel(Y, ref) < 1e-5
