"""Cosine-modulated filterbank gates: golden reconstruction + JAX parity."""

import numpy as np
import pytest

from golden import cmfb as gcmfb
from dsr.ops import cmfb as jcmfb


@pytest.fixture(scope="module")
def d():
    return gcmfb.design(32, m=8)


def test_golden_reconstruction(d):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(6000)
    y = gcmfb.synthesis(gcmfb.analysis(x, d), d, len(x))
    L = d.ha.shape[1]
    seg = slice(2 * L, len(x) - 2 * L)
    err = 20 * np.log10(np.max(np.abs(y[seg] - x[seg])) / np.max(np.abs(x)))
    assert err < -40.0


def test_jax_matches_golden(d):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4000).astype(np.float32)
    U_g = gcmfb.analysis(x.astype(np.float64), d)
    U_j = np.asarray(jcmfb.analysis(x, d))
    assert U_g.shape == U_j.shape
    assert np.max(np.abs(U_g - U_j)) / (np.max(np.abs(U_g)) + 1e-12) < 1e-4
    y_g = gcmfb.synthesis(U_g, d, len(x))
    y_j = np.asarray(jcmfb.synthesis(U_j, d, len(x)))
    assert np.max(np.abs(y_g - y_j)) / (np.max(np.abs(y_g)) + 1e-12) < 1e-3


def test_jax_batched_roundtrip(d):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5000)).astype(np.float32)
    U = jcmfb.analysis(x, d)
    y = np.asarray(jcmfb.synthesis(U, d, x.shape[1]))
    L = d.ha.shape[1]
    seg = slice(2 * L, x.shape[1] - 2 * L)
    err = np.max(np.abs(y[:, seg] - x[:, seg])) / np.max(np.abs(x))
    assert 20 * np.log10(err) < -40.0
