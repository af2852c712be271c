"""Filterbank gates: PR error (< -50 dB, SURVEY.md §7 gate A) + golden parity."""

import numpy as np
import pytest

from golden import filterbank as gfb
from dsr.config import FilterbankConfig
from dsr.ops import filterbank as jfb

CFG = FilterbankConfig(M=64, m=4, r=2)


@pytest.fixture(scope="module")
def protos():
    return jfb.get_prototypes(CFG)


def test_design_pr_error(protos):
    hf, gf, delay = protos
    assert gfb.pr_error_db(hf, gf, CFG.M, CFG.m, CFG.r, delay) < -50.0


def test_golden_reconstruction(protos):
    hf, gf, delay = protos
    rng = np.random.default_rng(0)
    x = rng.standard_normal(6 * CFG.L + 137)
    A = gfb.analysis(x, hf, CFG.M, CFG.r)
    y = gfb.synthesis(A, gf, CFG.M, CFG.r, delay, len(x))
    err_db = 20 * np.log10(np.max(np.abs(y - x)) / np.max(np.abs(x)))
    assert err_db < -50.0


def test_jax_matches_golden_analysis(protos):
    hf, gf, delay = protos
    rng = np.random.default_rng(1)
    x = rng.standard_normal(3 * CFG.L + 41).astype(np.float32)
    A_g = gfb.analysis(x.astype(np.float64), hf, CFG.M, CFG.r)
    A_j = np.asarray(jfb.analysis(x, CFG))
    assert A_j.shape == A_g.shape
    scale = np.max(np.abs(A_g)) + 1e-30
    assert np.max(np.abs(A_j - A_g)) / scale < 1e-5


def test_jax_roundtrip_and_golden_parity(protos):
    hf, gf, delay = protos
    rng = np.random.default_rng(2)
    x = rng.standard_normal(4 * CFG.L + 7).astype(np.float32)
    A = jfb.analysis(x, CFG)
    y = np.asarray(jfb.synthesis(A, CFG, len(x)))
    err_db = 20 * np.log10(np.max(np.abs(y - x)) / np.max(np.abs(x)))
    assert err_db < -50.0
    # parity with golden synthesis on the same coefficients
    y_g = gfb.synthesis(np.asarray(A, np.complex128), gf, CFG.M, CFG.r, delay, len(x))
    assert np.max(np.abs(y - y_g)) / (np.max(np.abs(y_g)) + 1e-30) < 1e-5


def test_batched_channels(protos):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, CFG.L * 2)).astype(np.float32)
    A = np.asarray(jfb.analysis(x, CFG))
    A0 = np.asarray(jfb.analysis(x[1, 2], CFG))
    assert A.shape[:2] == (2, 3)
    np.testing.assert_allclose(A[1, 2], A0, rtol=0, atol=1e-6)


def test_sine_passthrough(protos):
    """A pure tone must come back with unit gain (PR in the passband)."""
    sr = 16000.0
    t = np.arange(8 * CFG.L) / sr
    x = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    A = jfb.analysis(x, CFG)
    y = np.asarray(jfb.synthesis(A, CFG, len(x)))
    seg = slice(CFG.L, -CFG.L)  # ignore edge transients
    err = np.max(np.abs(y[seg] - x[seg]))
    assert err < 3e-3
