"""Feature front-end gates: golden parity for MFCC / CMN / deltas / LPC /
warped-MVDR; VTLN monotonicity."""

import numpy as np

from golden import features as gft
from golden import lpc as glpc
from dsr.ops import features as jft
from dsr.ops import lpc as jlpc

SR = 16000.0


def _speechish(S, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(S) / SR
    x = (
        0.6 * np.sin(2 * np.pi * 180 * t)
        + 0.3 * np.sin(2 * np.pi * 700 * t + 1.0)
        + 0.2 * np.sin(2 * np.pi * 2400 * t + 2.0)
        + 0.05 * rng.standard_normal(S)
    )
    return (x * np.hanning(S)).astype(np.float64)


def test_mfcc_parity():
    x = _speechish(8000)
    f_g = gft.mfcc(x, SR)
    f_j = np.asarray(jft.mfcc(x.astype(np.float32), SR))
    assert f_g.shape == f_j.shape
    scale = np.max(np.abs(f_g))
    assert np.max(np.abs(f_g - f_j)) / scale < 2e-4


def test_mfcc_from_subbands_parity():
    rng = np.random.default_rng(1)
    M = 256
    Y = rng.standard_normal((40, M // 2 + 1)) + 1j * rng.standard_normal((40, M // 2 + 1))
    f_g = gft.mfcc_from_subbands(Y, M, SR)
    f_j = np.asarray(jft.mfcc_from_subbands(Y.astype(np.complex64), M, SR))
    assert np.max(np.abs(f_g - f_j)) / np.max(np.abs(f_g)) < 2e-4


def test_cmn_deltas_parity():
    rng = np.random.default_rng(2)
    f = rng.standard_normal((50, 13))
    np.testing.assert_allclose(np.asarray(jft.cmn(f.astype(np.float32))), gft.cmn(f), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(jft.deltas(f.astype(np.float32))), gft.deltas(f), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(jft.add_deltas(f.astype(np.float32))), gft.add_deltas(f), atol=1e-5
    )


def test_vtln_warp_changes_features_monotonically():
    x = _speechish(8000)
    f_lo = np.asarray(jft.mfcc(x.astype(np.float32), SR, vtln_warp=0.9))
    f_mid = np.asarray(jft.mfcc(x.astype(np.float32), SR, vtln_warp=1.0))
    f_hi = np.asarray(jft.mfcc(x.astype(np.float32), SR, vtln_warp=1.1))
    d_lo = np.linalg.norm(f_lo - f_mid)
    d_hi = np.linalg.norm(f_hi - f_mid)
    assert d_lo > 1e-3 and d_hi > 1e-3  # warping does something
    # golden and jax agree under warp too
    g_hi = gft.mfcc(x, SR, vtln_warp=1.1)
    assert np.max(np.abs(g_hi - f_hi)) / np.max(np.abs(g_hi)) < 2e-4


def test_levinson_parity_and_whitening():
    x = _speechish(1024, seed=3)
    r_g = glpc.autocorr(x, 12)
    r_j = np.asarray(jlpc.autocorr(x.astype(np.float32), 12))
    np.testing.assert_allclose(r_j, r_g, rtol=1e-4, atol=1e-7)
    a_g, err_g = glpc.levinson(r_g)
    a_j, err_j = jlpc.levinson(r_g.astype(np.float32)[None])
    np.testing.assert_allclose(np.asarray(a_j)[0], a_g, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(err_j[0]), err_g, rtol=1e-3)
    assert err_g < r_g[0]  # prediction reduces error


def test_warped_autocorr_parity():
    x = _speechish(400, seed=4)
    r_g = glpc.warped_autocorr(x, 8, 0.4595)
    r_j = np.asarray(jlpc.warped_autocorr(x.astype(np.float32)[None], 8, 0.4595))[0]
    np.testing.assert_allclose(r_j, r_g, rtol=1e-3, atol=1e-6)


def test_mvdr_envelope_parity_and_bounds():
    x = _speechish(400, seed=5)
    r = glpc.autocorr(x, 12)
    a, err = glpc.levinson(r)
    env_g = glpc.mvdr_envelope(a, err, 65)
    env_j = np.asarray(jlpc.mvdr_envelope(a.astype(np.float32)[None], np.float32(err)[None], 65))[0]
    np.testing.assert_allclose(env_j, env_g, rtol=1e-2, atol=1e-8)
    # MVDR envelope lies below the LPC envelope (classical property)
    lpc_g = glpc.lpc_envelope(a, err, 65)
    assert np.all(env_g <= lpc_g * 1.001)


def test_warped_mvdr_cepstra_pipeline():
    frames = np.stack([_speechish(400, seed=s) for s in range(3)]).astype(np.float32)
    c_j = np.asarray(jlpc.warped_mvdr_cepstra(frames, order=16, num_bins=65))
    c_g = np.stack(
        [glpc.warped_mvdr_cepstra(f.astype(np.float64), 16, 0.4595, 65) for f in frames]
    )
    assert c_j.shape == (3, 13)
    assert np.max(np.abs(c_j - c_g)) / np.max(np.abs(c_g)) < 5e-3
