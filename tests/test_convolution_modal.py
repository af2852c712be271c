"""Overlap-add/save FIR + modal beamformer gates."""

import numpy as np
import pytest

from golden import convolution as gconv
from golden import modal as gmodal
from dsr.ops import convolution as jconv
from dsr.ops import modal as jmodal


def test_overlap_add_save_match_direct():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(5000)
    h = rng.standard_normal(101)
    ref = np.convolve(x, h)[: len(x)]
    for block in [256, 1000]:
        np.testing.assert_allclose(gconv.overlap_add(x, h, block), ref, atol=1e-8)
        np.testing.assert_allclose(gconv.overlap_save(x, h, block), ref, atol=1e-8)
        np.testing.assert_allclose(
            np.asarray(jconv.overlap_add(x.astype(np.float32), h.astype(np.float32), block)),
            ref, atol=2e-3,
        )
        np.testing.assert_allclose(
            np.asarray(jconv.overlap_save(x.astype(np.float32), h.astype(np.float32), block)),
            ref, atol=2e-3,
        )


def test_overlap_add_batched():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 2000)).astype(np.float32)
    h = rng.standard_normal(33).astype(np.float32)
    out = np.asarray(jconv.overlap_add(x, h, 512))
    for i in range(3):
        ref = np.convolve(x[i], h)[:2000]
        np.testing.assert_allclose(out[i], ref, atol=2e-3)


def test_modal_beamformer_steers():
    """Plane wave from the look direction → near-unit gain; off-look → lower."""
    order = 3
    Q = 32
    dirs = jmodal.sphere_mic_dirs(Q)
    ka = 2.0
    look = np.array([np.pi / 2, 0.0])
    w = gmodal.modal_weights(order, ka, dirs, look, reg=1e-3)
    p_on = gmodal.plane_wave_pressure(order, ka, dirs, look)
    gain_on = abs(np.conj(w) @ p_on)
    gains_off = []
    for az in [1.2, 2.2, 3.0]:
        off = np.array([np.pi / 2, az])
        p_off = gmodal.plane_wave_pressure(order, ka, dirs, off)
        gains_off.append(abs(np.conj(w) @ p_off))
    assert gain_on > 0.5
    assert max(gains_off) < 0.6 * gain_on


def test_modal_subband_weights_shape():
    W = jmodal.modal_weights_subband(2, 0.05, 64, 16000.0,
                                     jmodal.sphere_mic_dirs(16), np.array([1.0, 0.5]))
    assert W.shape == (33, 16)
    assert np.all(np.isfinite(W))
