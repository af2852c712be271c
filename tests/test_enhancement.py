"""Postfilter / AEC / VAD / WPE gates: golden parity + functional checks."""

import numpy as np
import pytest

from golden import aec as gaec
from golden import dereverb as gder
from golden import postfilter as gpf
from golden import sad as gsad
from dsr.ops import aec as jaec
from dsr.ops import dereverb as jder
from dsr.ops import postfilter as jpf
from dsr.ops import sad as jsad


def _snapshots(rng, N=4, T=30, K=17, coherent_frac=0.7):
    s = rng.standard_normal((T, K)) + 1j * rng.standard_normal((T, K))
    noise = rng.standard_normal((N, T, K)) + 1j * rng.standard_normal((N, T, K))
    return coherent_frac * s[None] + (1 - coherent_frac) * noise


def test_zelinski_parity_and_behavior():
    rng = np.random.default_rng(0)
    X = _snapshots(rng)
    H_g = gpf.zelinski_weights(X)
    H_j = np.asarray(jpf.zelinski_weights(X.astype(np.complex64)))
    assert np.max(np.abs(H_g - H_j)) < 1e-3
    # coherent signal → gains near 1; incoherent noise only → near floor
    Xn = _snapshots(rng, coherent_frac=0.0)
    H_n = gpf.zelinski_weights(Xn)
    assert H_g.mean() > 0.7 and H_n.mean() < 0.4


def test_mccowan_parity():
    rng = np.random.default_rng(1)
    N, K = 4, 17
    X = _snapshots(rng, N=N, K=K)
    Gamma = np.tile(np.eye(N), (K, 1, 1)) * 0.0  # incoherent noise model
    H_g = gpf.mccowan_weights(X, Gamma)
    H_j = np.asarray(jpf.mccowan_weights(X.astype(np.complex64), Gamma.astype(np.float32)))
    assert np.max(np.abs(H_g - H_j)) < 1e-3


def test_apab_and_mask_parity():
    rng = np.random.default_rng(2)
    Y = rng.standard_normal((30, 17)) + 1j * rng.standard_normal((30, 17))
    Z = 0.3 * (rng.standard_normal((30, 17)) + 1j * rng.standard_normal((30, 17)))
    np.testing.assert_allclose(
        np.asarray(jpf.apab_weights(Y.astype(np.complex64), Z.astype(np.complex64))),
        gpf.apab_weights(Y, Z),
        atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(jpf.binary_mask(Y.astype(np.complex64), Z.astype(np.complex64))),
        gpf.binary_mask(Y, Z),
        atol=1e-6,
    )


def test_nlms_aec_parity_and_erle():
    rng = np.random.default_rng(3)
    T, K, taps = 200, 9, 3
    F = (rng.standard_normal((T, K)) + 1j * rng.standard_normal((T, K)))
    true_w = (rng.standard_normal((K, taps)) + 1j * rng.standard_normal((K, taps))) * 0.5
    D = np.zeros((T, K), complex)
    hist = np.zeros((K, taps), complex)
    for t in range(T):
        hist = np.roll(hist, 1, axis=1)
        hist[:, 0] = F[t]
        D[t] = np.sum(np.conj(true_w) * hist, axis=1)
    E_g, W_g = gaec.nlms_aec(D, F, taps=taps)
    E_j, W_j = jaec.nlms_aec(D.astype(np.complex64), F.astype(np.complex64), taps=taps)
    assert np.max(np.abs(np.asarray(E_j) - E_g)) < 1e-2
    # echo return loss enhancement after convergence
    erle = 10 * np.log10(np.mean(np.abs(D[T // 2 :]) ** 2) / np.mean(np.abs(E_g[T // 2 :]) ** 2))
    assert erle > 20.0


def test_kalman_aec_parity_and_convergence():
    rng = np.random.default_rng(4)
    T, K, taps = 150, 9, 2
    F = rng.standard_normal((T, K)) + 1j * rng.standard_normal((T, K))
    true_w = (rng.standard_normal((K, taps)) + 1j * rng.standard_normal((K, taps))) * 0.5
    D = np.zeros((T, K), complex)
    hist = np.zeros((K, taps), complex)
    for t in range(T):
        hist = np.roll(hist, 1, axis=1)
        hist[:, 0] = F[t]
        D[t] = np.sum(np.conj(true_w) * hist, axis=1) + 0.01 * (
            rng.standard_normal(K) + 1j * rng.standard_normal(K)
        )
    E_g, W_g = gaec.kalman_aec(D, F, taps=taps)
    E_j, W_j = jaec.kalman_aec(D.astype(np.complex64), F.astype(np.complex64), taps=taps)
    assert np.max(np.abs(np.asarray(E_j) - E_g)) < 1e-2
    erle = 10 * np.log10(np.mean(np.abs(D[T // 2 :]) ** 2) / np.mean(np.abs(E_g[T // 2 :]) ** 2))
    assert erle > 15.0


def test_energy_vad_parity_and_detection():
    rng = np.random.default_rng(5)
    T = 120
    p = np.full(T, 1e-4)
    p[40:70] = 1e-2  # speech burst
    p *= 1 + 0.1 * rng.random(T)
    d_g = gsad.energy_vad(p)
    d_j = np.asarray(jsad.energy_vad(p.astype(np.float32)))
    np.testing.assert_array_equal(d_g, d_j)
    assert d_g[45:65].mean() > 0.9 and d_g[:35].mean() < 0.2


def test_sohn_vad_parity():
    rng = np.random.default_rng(6)
    T, K = 80, 17
    noise_psd = np.full(K, 1.0)
    P = rng.chisquare(2, (T, K)) / 2
    P[30:50] *= 8.0
    d_g, llr_g = gsad.sohn_vad(P, noise_psd)
    d_j, llr_j = jsad.sohn_vad(P.astype(np.float32), noise_psd.astype(np.float32))
    np.testing.assert_allclose(np.asarray(llr_j), llr_g, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(d_j), d_g)
    assert d_g[32:48].mean() > 0.9


def test_wpe_parity_and_dereverberation():
    rng = np.random.default_rng(7)
    N, T, K = 2, 60, 9
    # synthetic "reverberant" subband data: AR smearing of a dry source
    dry = (rng.standard_normal((N, T, K)) + 1j * rng.standard_normal((N, T, K))) * (
        rng.random((1, T, 1)) > 0.5
    )
    Y = dry.copy()
    for t in range(3, T):
        Y[:, t] += 0.6 * Y[:, t - 3] * 0.9
    D_g = gder.wpe(Y, taps=4, delay=2, iters=2)
    D_j = np.asarray(jder.wpe(Y.astype(np.complex64), taps=4, delay=2, iters=2))
    scale = np.max(np.abs(D_g))
    assert np.max(np.abs(D_j - D_g)) / scale < 2e-2  # f32 solve vs f64
    # late-reverb energy reduced: output closer to dry than input is
    err_in = np.mean(np.abs(Y - dry) ** 2)
    err_out = np.mean(np.abs(D_g - dry) ** 2)
    assert err_out < 0.5 * err_in


def test_segments_from_vad():
    d = np.zeros(200, np.int32)
    d[30:80] = 1
    d[85:90] = 1   # close run: merged
    d[150:155] = 1  # too short: dropped
    segs = jsad.segments_from_vad(d, min_speech=10, min_gap=15, pad=5)
    assert len(segs) == 1
    s, e = segs[0]
    assert s == 25 and e == 95


def test_objective_measures():
    from dsr.utils import objective

    rng = np.random.default_rng(0)
    ref = np.sin(2 * np.pi * 440 * np.arange(16000) / 16000.0)
    noisy = ref + 0.1 * rng.standard_normal(len(ref))
    cleaner = ref + 0.01 * rng.standard_normal(len(ref))
    assert objective.si_sdr(cleaner, ref) > objective.si_sdr(noisy, ref) + 10
    assert objective.segmental_snr(cleaner, ref) > objective.segmental_snr(noisy, ref)
    assert objective.fw_segmental_snr(cleaner, ref) > objective.fw_segmental_snr(noisy, ref)


def test_lefkimmiatis_parity_and_behavior():
    rng = np.random.default_rng(11)
    N, T, K = 4, 60, 33
    X = rng.standard_normal((N, T, K)) + 1j * rng.standard_normal((N, T, K))
    Gamma = np.broadcast_to(np.eye(N) * 1.0 + 0.3 * (1 - np.eye(N)), (K, N, N)).copy()
    w = (rng.standard_normal((K, N)) + 1j * rng.standard_normal((K, N))) / N
    H_g = gpf.lefkimmiatis_weights(X, Gamma, w)
    H_j = np.asarray(
        jpf.lefkimmiatis_weights(X.astype(np.complex64), Gamma.astype(np.float32),
                                 w.astype(np.complex64))
    )
    assert H_g.shape == (T, K) and np.all(H_g >= 0.1 - 1e-9) and np.all(H_g <= 1.0 + 1e-9)
    assert np.max(np.abs(H_g - H_j)) < 2e-3
    # coherent (speech-like) input → gain near 1; incoherent noise → floored low
    Xc = np.broadcast_to(X[:1], X.shape)
    Hc = gpf.lefkimmiatis_weights(Xc, Gamma, w)
    assert np.mean(Hc) > 0.9
    assert np.mean(H_g) < np.mean(Hc)
