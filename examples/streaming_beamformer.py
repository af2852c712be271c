"""Streaming DSR demo: native ring-buffer WAV reader → chunked beamforming.

Writes a synthetic 8-channel WAV, then streams it through the native C++
sample streamer (`dsr.utils.audio.SampleStream`) into the chunked
pipeline, writing the enhanced single-channel WAV out — the reference's
pull-model file→beamformer→file chain (SURVEY.md §3.1), streaming-state
and all, on the batched JAX stack.

    python examples/streaming_beamformer.py
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from golden import room as groom
from dsr.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr.pipeline import DsrPipeline
from dsr.utils import audio

SR = 16000.0


def main():
    geom = ArrayGeometry.linear(8, 0.04)
    POS = np.asarray(geom.positions)
    pos = np.array([0.0, 2.0, 0.0])
    rng = np.random.default_rng(0)
    S = 64000
    t = np.arange(S) / SR
    src = (np.sin(2 * np.pi * 300 * t) + 0.5 * np.sin(2 * np.pi * 880 * t)) * 0.2
    x = groom.simulate(src, POS, pos, SR, snr_db=5.0, rng=rng).astype(np.float32)

    tmp = tempfile.mkdtemp()
    in_path = os.path.join(tmp, "array8.wav")
    out_path = os.path.join(tmp, "enhanced.wav")
    audio.write_wav(in_path, x, int(SR), pcm16=False)

    pipe = DsrPipeline(
        fb=FilterbankConfig(M=256, m=4, r=2),
        geometry=geom,
        beamformer=BeamformerConfig(kind="gsc"),
        postfilter="zelinski",
    )
    out = []
    with audio.SampleStream(in_path, block_frames=8000) as stream:
        print(f"streaming {in_path}: {stream.channels} ch @ {stream.sample_rate} Hz")
        for y in pipe.process_streaming(stream, pos):
            out.append(y)
            print(f"  emitted {len(y)} enhanced samples")
    y = np.concatenate(out)[:S]
    audio.write_wav(out_path, y, int(SR))
    noisy_ref = x[0]
    snr_in = 10 * np.log10(np.mean(src**2) / np.mean((noisy_ref - src) ** 2))
    print(f"wrote {out_path} ({len(y)} samples); input ch0 SNR ≈ {snr_in:.1f} dB")


if __name__ == "__main__":
    main()
