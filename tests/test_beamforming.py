"""Beamformer gates: golden parity + physical sanity (array gain, nulls)."""

import numpy as np
import pytest

from golden import beamforming as gbf
from golden import filterbank as gfb
from golden import room as groom
from dsr.config import ArrayGeometry, FilterbankConfig
from dsr.ops import beamforming as jbf
from dsr.ops import filterbank as jfb

SR = 16000.0
M = 64
CFG = FilterbankConfig(M=M, m=4, r=2)
GEOM = ArrayGeometry.linear(8, 0.04)
POS = np.asarray(GEOM.positions)


def test_steering_parity():
    taus = groom.steering_delays(POS, np.array([1.0, 2.0, 0.3]), 343.0, SR) / SR
    v_g = gbf.steering_vectors(taus, M, SR)
    v_j = np.asarray(jbf.steering_vectors(taus.astype(np.float32), M, SR))
    assert np.max(np.abs(v_g - v_j)) < 1e-5


def test_mvdr_weights_parity_and_distortionless():
    taus = groom.steering_delays(POS, np.array([2.0, 0.5, 0.0]), 343.0, SR) / SR
    v = gbf.steering_vectors(taus, M, SR)
    Gamma = gbf.diffuse_coherence(POS, M, SR, 343.0)
    w_g = gbf.mvdr_weights(v, Gamma, loading=1e-2)
    w_j = np.asarray(jbf.mvdr_weights(v.astype(np.complex64), Gamma.astype(np.float32), 1e-2))
    # distortionless: w^H v = 1 per bin
    np.testing.assert_allclose(np.sum(np.conj(w_g) * v, axis=1), 1.0, atol=1e-10)
    np.testing.assert_allclose(np.sum(np.conj(w_j) * v, axis=1), 1.0, atol=1e-3)
    assert np.max(np.abs(w_g - w_j)) < 1e-3


def test_blocking_matrix():
    taus = groom.steering_delays(POS, np.array([1.5, -1.0, 0.2]), 343.0, SR) / SR
    v = gbf.steering_vectors(taus, M, SR)
    B_g = gbf.blocking_matrix(v)
    B_j = np.asarray(jbf.blocking_matrix(v.astype(np.complex64)))
    K, N = v.shape
    for k in [0, K // 2, K - 1]:
        # v ⟂ columns, orthonormal columns
        assert np.max(np.abs(np.conj(v[k]) @ B_g[k])) < 1e-10
        eye = np.conj(B_g[k]).T @ B_g[k]
        np.testing.assert_allclose(eye, np.eye(N - 1), atol=1e-10)
    assert np.max(np.abs(B_g - B_j)) < 1e-4


def test_gsc_nlms_parity():
    rng = np.random.default_rng(0)
    N, T, K = 4, 40, M // 2 + 1
    taus = groom.steering_delays(POS[:N], np.array([1.0, 1.0, 0.0]), 343.0, SR) / SR
    v = gbf.steering_vectors(taus, M, SR)
    wq = gbf.ds_weights(v)
    B = gbf.blocking_matrix(v)
    X = (rng.standard_normal((N, T, K)) + 1j * rng.standard_normal((N, T, K))).astype(np.complex64)
    Y_g, wa_g = gbf.gsc_nlms(X.astype(np.complex128), wq, B, mu=0.1)
    Y_j, wa_j = jbf.gsc_nlms(X, wq.astype(np.complex64), B.astype(np.complex64), mu=0.1)
    assert np.max(np.abs(np.asarray(Y_j) - Y_g)) / np.max(np.abs(Y_g)) < 1e-3
    assert np.max(np.abs(np.asarray(wa_j) - wa_g)) < 1e-3


def _beamform_ds_pipeline(x_multi, source_pos):
    """8-ch DS beamform through the full subband pipeline → time signal."""
    taus = groom.steering_delays(POS, source_pos, 343.0, SR) / SR
    A = jfb.analysis(x_multi.astype(np.float32), CFG)        # (N, T, K)
    v = jbf.steering_vectors(taus.astype(np.float32), M, SR)
    Y = jbf.apply_weights(A, jbf.ds_weights(v))              # (T, K)
    return np.asarray(jfb.synthesis(Y, CFG, x_multi.shape[-1]))


def test_ds_array_gain():
    """DS beamforming of a source in white noise: ~10·log10(N) SNR gain."""
    rng = np.random.default_rng(1)
    S = 16384
    src = np.sin(2 * np.pi * 700.0 * np.arange(S) / SR) * np.hanning(S)
    pos = np.array([0.0, 2.0, 0.0])  # broadside
    snr_in = 0.0
    x = groom.simulate(src, POS, pos, SR, snr_db=snr_in, rng=rng)
    y = _beamform_ds_pipeline(x, pos)
    # clean reference through the same pipeline (no noise)
    xc = groom.simulate(src, POS, pos, SR, snr_db=None, rng=rng)
    yc = _beamform_ds_pipeline(xc, pos)
    noise_out = y - yc
    seg = slice(CFG.L, S - CFG.L)
    snr_out = 10 * np.log10(np.mean(yc[seg] ** 2) / np.mean(noise_out[seg] ** 2))
    gain = snr_out - snr_in
    assert gain > 7.0, f"array gain {gain:.1f} dB < 7 dB (expect ≈9 for N=8)"
    # and the signal itself must come through undistorted
    err = np.max(np.abs(yc[seg] - src[seg])) / np.max(np.abs(src))
    assert err < 0.05


def test_gsc_converges_to_null_interferer():
    """GSC must suppress a directional interferer well below plain DS.

    Needs M=256: a single complex tap per bin can only cancel an interferer
    whose delay spread is small relative to the bin bandwidth — the same
    subband-resolution argument behind the reference's M=256 designs [K].
    """
    cfg = FilterbankConfig(M=256, m=4, r=2)
    rng = np.random.default_rng(2)
    S = 32768
    jam = rng.standard_normal(S)
    pos_s = np.array([0.0, 2.0, 0.0])
    pos_j = np.array([2.0, 1.0, 0.0])
    xj = groom.simulate(jam, POS, pos_j, SR, snr_db=None, rng=rng)
    taus = groom.steering_delays(POS, pos_s, 343.0, SR) / SR
    A = jfb.analysis(xj.astype(np.float32), cfg)
    v = jbf.steering_vectors(taus.astype(np.float32), cfg.M, SR)
    wq = jbf.ds_weights(v)
    B = jbf.blocking_matrix(v)
    Y_ds = np.asarray(jbf.apply_weights(A, wq))
    Y_gsc, _ = jbf.gsc_nlms(A, wq, B, mu=0.1)
    Y_gsc = np.asarray(Y_gsc)
    half = Y_ds.shape[0] // 2  # after convergence
    sup_db = 10 * np.log10(
        np.mean(np.abs(Y_ds[half:]) ** 2) / np.mean(np.abs(Y_gsc[half:]) ** 2)
    )
    assert sup_db > 5.0, f"GSC suppresses jam only {sup_db:.1f} dB below DS"


def test_gsc_block_matches_sequential_steady_state():
    """Block-LMS fast path cancels a rank-1 interferer like per-frame NLMS.

    Per bin, X = u_k · s + ε is rank-1, so the Wiener active weights are
    well-defined and both adaptation schedules must reach them (measured as
    residual interferer power at the output).
    """
    rng = np.random.default_rng(3)
    N, T, K = 4, 512, M // 2 + 1
    taus = groom.steering_delays(POS[:N], np.array([0.0, 1.0, 0.0]), 343.0, SR) / SR
    v = np.asarray(jbf.steering_vectors(taus.astype(np.float32), M, SR))
    wq = v / N
    B = np.asarray(jbf.blocking_matrix(v))
    taus_j = groom.steering_delays(POS[:N], np.array([1.5, 0.7, 0.0]), 343.0, SR) / SR
    u = np.asarray(jbf.steering_vectors(taus_j.astype(np.float32), M, SR))  # (K, N)
    s = (rng.standard_normal((T, K)) + 1j * rng.standard_normal((T, K))).astype(np.complex64)
    X = (u.T[:, None, :] * s[None]).astype(np.complex64)  # (N, T, K)
    X += 0.01 * (rng.standard_normal(X.shape) + 1j * rng.standard_normal(X.shape)).astype(
        np.complex64
    )
    Y_seq, _ = jbf.gsc_nlms(X, wq, B, mu=0.2)
    Y_blk, _ = jbf.gsc_nlms_block(X, wq, B, mu=0.2, block=16)
    Y_ds = np.asarray(jbf.apply_weights(X, wq))
    half = T // 2
    hi = slice(K // 3, None)  # low bins: u ≈ v (tiny aperture), uncancellable
    p_ds = np.mean(np.abs(Y_ds[half:, hi]) ** 2)
    p_seq = np.mean(np.abs(np.asarray(Y_seq)[half:, hi]) ** 2)
    p_blk = np.mean(np.abs(np.asarray(Y_blk)[half:, hi]) ** 2)
    assert 10 * np.log10(p_ds / p_seq) > 15.0
    assert 10 * np.log10(p_ds / p_blk) > 15.0


def test_mvdr_precompute_matches_direct():
    taus = groom.steering_delays(POS, np.array([2.0, 0.5, 0.0]), 343.0, SR) / SR
    v = gbf.steering_vectors(taus, M, SR).astype(np.complex64)
    Gamma = gbf.diffuse_coherence(POS, M, SR, 343.0).astype(np.float32)
    w_direct = np.asarray(jbf.mvdr_weights(v, Gamma, 1e-2))
    Ginv = jbf.mvdr_precompute(Gamma, 1e-2)
    w_pre = np.asarray(jbf.mvdr_weights_from_inv(v, Ginv))
    assert np.max(np.abs(w_direct - w_pre)) < 1e-4


def test_gsc_maxkurt_parity_and_interference_suppression():
    """SubbandMMI parity gate: jax == golden, and the max-kurtosis GSC
    nulls a Gaussian interferer while passing the super-Gaussian target."""
    rng = np.random.default_rng(7)
    N, T, K = 4, 300, M // 2 + 1
    taus_s = groom.steering_delays(POS[:N], np.array([0.0, 2.0, 0.0]), 343.0, SR) / SR
    taus_i = groom.steering_delays(POS[:N], np.array([2.0, 1.0, 0.0]), 343.0, SR) / SR
    v_s = gbf.steering_vectors(taus_s, M, SR)
    v_i = gbf.steering_vectors(taus_i, M, SR)
    # super-Gaussian target (Laplacian magnitude), Gaussian interferer
    s = rng.laplace(size=(T, K)) * np.exp(2j * np.pi * rng.random((T, K)))
    n = (rng.standard_normal((T, K)) + 1j * rng.standard_normal((T, K))) * 2.0
    X = v_s.T[:, None, :] * s[None] + v_i.T[:, None, :] * n[None]
    X += 0.01 * (rng.standard_normal(X.shape) + 1j * rng.standard_normal(X.shape))
    wq = gbf.ds_weights(v_s)
    B = gbf.blocking_matrix(v_s)
    # parity at few iterations (complex64 drift compounds per gradient step)
    Yp_g, wap_g = gbf.gsc_maxkurt(X, wq, B, mu=0.1, iters=6)
    Yp_j, wap_j = jbf.gsc_maxkurt(
        X.astype(np.complex64), wq.astype(np.complex64), B.astype(np.complex64),
        0.1, 6, 2.0,
    )
    assert np.max(np.abs(np.asarray(wap_j) - wap_g)) < 5e-3
    assert np.max(np.abs(np.asarray(Yp_j) - Yp_g)) < 5e-2
    Y_g, wa_g = gbf.gsc_maxkurt(X, wq, B, mu=0.1, iters=50)
    # interference gain |w^H v_i| drops vs the quiescent DS beam; target
    # gain stays distortionless (w^H v_s == 1 by GSC structure).
    w_final = wq - np.einsum("knm,km->kn", B, wa_g)
    gain_t = np.abs(np.sum(np.conj(w_final) * v_s, axis=1))
    gain_i = np.abs(np.sum(np.conj(w_final) * v_i, axis=1))
    gain_i_q = np.abs(np.sum(np.conj(wq) * v_i, axis=1))
    np.testing.assert_allclose(gain_t, 1.0, atol=1e-6)
    assert np.mean(gain_i) < 0.6 * np.mean(gain_i_q)
