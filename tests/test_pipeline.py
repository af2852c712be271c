"""Compose-stages pipeline API gates incl. streaming-equals-offline."""

import numpy as np
import pytest

from golden import room as groom
from dsr.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr.pipeline import DsrPipeline

SR = 16000.0


def _mix(seed=0, S=24000, N=6):
    rng = np.random.default_rng(seed)
    src = np.sin(2 * np.pi * 500 * np.arange(S) / SR) * np.hanning(S)
    POS = np.asarray(ArrayGeometry.linear(N, 0.04).positions)
    pos = np.array([0.3, 1.8, 0.0])
    x = groom.simulate(src, POS, pos, SR, snr_db=10.0, rng=rng)
    return x.astype(np.float32), pos


@pytest.mark.parametrize("kind", ["ds", "mvdr", "gsc"])
def test_pipeline_kinds_run(kind):
    x, pos = _mix()
    pipe = DsrPipeline(
        fb=FilterbankConfig(M=64, m=4, r=2),
        geometry=ArrayGeometry.linear(6, 0.04),
        beamformer=BeamformerConfig(kind=kind),
    )
    y, feats = pipe.process(x, pos)
    assert y.shape == (x.shape[-1],)
    assert feats.ndim == 2 and np.all(np.isfinite(np.asarray(feats)))


def test_pipeline_postfilter_and_dereverb():
    x, pos = _mix(seed=1)
    pipe = DsrPipeline(
        fb=FilterbankConfig(M=64, m=4, r=2),
        geometry=ArrayGeometry.linear(6, 0.04),
        beamformer=BeamformerConfig(kind="ds"),
        postfilter="zelinski",
        dereverb=True,
    )
    y, feats = pipe.process(x, pos)
    assert np.all(np.isfinite(np.asarray(y)))


def test_streaming_matches_offline_for_fixed_beamformer():
    x, pos = _mix(seed=2, S=20000)
    pipe = DsrPipeline(
        fb=FilterbankConfig(M=64, m=4, r=2),
        geometry=ArrayGeometry.linear(6, 0.04),
        beamformer=BeamformerConfig(kind="mvdr"),
    )
    y_off, _ = pipe.process(x, pos)
    y_off = np.asarray(y_off)
    block = 4000
    chunks = [x[:, i : i + block] for i in range(0, x.shape[1], block)]
    y_str = np.concatenate(list(pipe.process_streaming(chunks, pos)))
    assert len(y_str) == len(y_off)
    # interior must match to filterbank precision (edges see different pads)
    seg = slice(pipe.fb.L, len(y_off) - pipe.fb.L)
    err = np.max(np.abs(y_str[seg] - y_off[seg])) / (np.max(np.abs(y_off)) + 1e-12)
    assert err < 1e-3, f"streaming vs offline err {err:.2e}"
