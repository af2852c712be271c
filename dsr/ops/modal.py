"""Modal (spherical-harmonic) eigenbeamformer for spherical arrays.

Numerics match `golden/modal.py` (reference modal beamformer [K]).
Weight design is offline NumPy/SciPy (spherical Bessel/harmonics); the
run-time application is the same bin-batched `apply_weights` every other
subband beamformer uses — (K, Q) conj-weights.
"""

from __future__ import annotations

import numpy as np

from golden.modal import modal_weights


def modal_weights_subband(
    order: int,
    radius: float,
    M: int,
    sample_rate: float,
    mic_dirs: np.ndarray,
    look_dir: np.ndarray,
    sound_speed: float = 343.0,
    reg: float = 1e-2,
) -> np.ndarray:
    """Per-bin modal weights → (K, Q) complex64 for `beamforming.apply_weights`."""
    K = M // 2 + 1
    freqs = np.arange(K) * sample_rate / M
    W = np.zeros((K, len(mic_dirs)), np.complex64)
    for k, f in enumerate(freqs):
        ka = 2 * np.pi * f * radius / sound_speed
        if ka < 1e-6:
            W[k] = 1.0 / len(mic_dirs)
            continue
        W[k] = modal_weights(order, ka, mic_dirs, look_dir, reg)
    return W


def sphere_mic_dirs(n: int) -> np.ndarray:
    """Near-uniform (colatitude, azimuth) directions via a Fibonacci sphere."""
    i = np.arange(n) + 0.5
    colat = np.arccos(1 - 2 * i / n)
    az = (np.pi * (1 + 5**0.5) * i) % (2 * np.pi)
    return np.stack([colat, az], axis=1)
