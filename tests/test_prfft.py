"""PR-FFT filterbank gates: exact reconstruction (COLA identity) and golden
parity — the critically/PR-sampled complement of the oversampled DFT bank
(reference PerfectReconstructionFFT banks, SURVEY.md §2.1 modulated [K])."""

import numpy as np
import pytest

from golden import prfft as gp
from dsr.ops import prfft as jp


@pytest.mark.parametrize("M,D", [(256, 128), (256, 64), (512, 256), (64, 64)])
def test_golden_perfect_reconstruction(M, D):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(5000)
    y = gp.synthesis(gp.analysis(x, M, D), M, D, len(x))
    err_db = 20 * np.log10(np.max(np.abs(y - x)) / np.max(np.abs(x)))
    assert err_db < -120.0      # exact up to float rounding


def test_cola_identity():
    M, D = 256, 64
    w = gp.design_cola_window(M, D)
    s = np.zeros(4 * M)
    for t in range(len(s) // D):
        if t * D + M <= len(s):
            s[t * D : t * D + M] += w * w
    mid = s[M : 2 * M]           # away from the edges
    np.testing.assert_allclose(mid, 1.0, atol=1e-12)


@pytest.mark.parametrize("M,D", [(256, 128), (128, 128)])
def test_jax_matches_golden_and_reconstructs(M, D):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4000)).astype(np.float32)
    A_g = np.stack([gp.analysis(xi, M, D) for xi in x])
    A_j = np.asarray(jp.analysis(x, M, D))
    assert A_j.shape == A_g.shape
    assert np.max(np.abs(A_j - A_g)) / np.max(np.abs(A_g)) < 1e-5
    y = np.asarray(jp.synthesis(jp.analysis(x, M, D), M, D, x.shape[-1]))
    err_db = 20 * np.log10(np.max(np.abs(y - x)) / np.max(np.abs(x)))
    assert err_db < -100.0
