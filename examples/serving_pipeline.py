"""End-to-end native serving path: WAV corpus → C++ batched prefetch
loader → device → analysis + MVDR beamform → MFCC features → LVCSR decode
(the loader feeding the device pipeline without host stalls).

Pipeline structure (what production serving would run):
  - `native/loader.cpp` worker pool prefetches + decodes the NEXT batch
    of WAVs on host threads while the device computes (the ctypes call
    releases the GIL; the C++ side overlaps disk + PCM decode);
  - each batch is `device_put` and processed by ONE jitted front-end
    program (analysis → MVDR apply → subband MFCC);
  - batches stay in flight: batch i's front end + decode is dispatched
    asynchronously (JAX dispatch returns before the device finishes) and
    only blocked on after later batches have been submitted, so
    load/upload/compute overlap.

It prints per-stage costs, the pipelined and sequential wall times, and
the device-side rate, for whatever device JAX runs on.

Run: python examples/serving_pipeline.py [n_utts]
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SR = 16000
SECS = 4.0
CH = 8
BATCH = 4


def make_corpus(root: str, n: int) -> list[str]:
    from dsr.utils.audio import write_wav

    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        x = 0.1 * rng.standard_normal((CH, int(SR * SECS))).astype(np.float32)
        p = os.path.join(root, f"utt{i:03d}.wav")
        write_wav(p, x, SR)
        paths.append(p)
    return paths


def main(n_utts: int = 16):
    import jax
    import jax.numpy as jnp

    from dsr.config import ArrayGeometry, FilterbankConfig
    from dsr.ops import beamforming as jbf
    from dsr.ops import features as jfeat
    from dsr.ops import filterbank as jfb
    from dsr.utils.audio import BatchLoader
    from dsr.asr import lvcsr
    from dsr.asr.decoder import topk_decoder as tk
    from golden import room as groom

    task = lvcsr.build_task(lvcsr.LvcsrConfig())
    tg = tk.build_token_graph(task.graph)
    # feature → pdf-loglik bridge: a fixed random projection (this demo's
    # corpus is synthetic noise; a trained AM drops in here — the point is
    # the full wav → loader → device → beamform → features → 532k-state
    # decode path under load)
    proj = jnp.asarray(np.random.default_rng(1).standard_normal(
        (13, task.num_pdfs)).astype(np.float32) * 0.1)

    cfg = FilterbankConfig(M=256, m=4, r=2)
    geom = ArrayGeometry.circular(CH, 0.1)
    POS = np.asarray(geom.positions)
    S = int(SR * SECS)
    taus = (groom.steering_delays(POS, np.array([0.0, 1.5, 0.0]), 343.0, SR)
            / SR).astype(np.float32)
    Gamma = jbf.diffuse_coherence(POS, cfg.M, float(SR), 343.0)
    w = jbf.mvdr_weights_from_inv(
        jbf.steering_vectors(jnp.asarray(taus), cfg.M, float(SR)),
        jbf.mvdr_precompute(Gamma, 1e-2))
    hfj = jnp.asarray(jfb.get_prototypes(cfg)[0], jnp.float32)

    def decode(ll):
        # the decoder manages its own jit: the 532k-state arc tables ride
        # as ARGUMENTS (closing over them inside another jit would embed
        # ~400 MB of constants in the compile payload)
        lens = np.full(ll.shape[0], ll.shape[1], np.int32)
        _, scores = tk.decode_batch(tg, ll, lens, kcap=256, beam=40.0)
        return scores

    @jax.jit
    def process(audio, w):
        """Raw audio batch (B, N, S) → beamformed subbands → MFCC → the
        (B, T, num_pdfs) loglik bridge; ONE jit call per batch."""
        Y = jbf.apply_weights(jfb.analysis(audio, cfg, hfj), w)
        return jfeat.mfcc_from_subbands(Y, cfg.M, float(SR)) @ proj

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = make_corpus(root, n_utts)
        t_gen = time.perf_counter() - t0

        # -- stage costs measured separately (one warm batch) -------------
        loader = BatchLoader(paths, BATCH, max_frames=S, max_channels=CH)
        audio, lens = next(loader)
        t0 = time.perf_counter()
        audio2, _ = next(loader)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev = jax.device_put(audio)
        dev.block_until_ready()
        t_up = time.perf_counter() - t0
        jax.block_until_ready(decode(process(dev, w)))  # warm compile
        t0 = time.perf_counter()
        jax.block_until_ready(decode(process(dev, w)))
        t_comp = time.perf_counter() - t0
        loader.close()

        # -- the pipelined serving loop -----------------------------------
        loader = BatchLoader(paths, BATCH, max_frames=S, max_channels=CH)
        t0 = time.perf_counter()
        inflight = []
        nb = 0
        total = 0.0
        for audio, lens in loader:
            if audio.shape[0] < BATCH:      # ragged tail: skip (fixed shapes)
                continue
            inflight.append(decode(process(jax.device_put(audio), w)))
            nb += 1
            if len(inflight) > 3:
                total += float(inflight.pop(0).sum())   # block on oldest
        for r in inflight:
            total += float(r.sum())
        t_pipe = time.perf_counter() - t0
        loader.close()

        # -- sequential baseline: block on every batch before the next ----
        loader = BatchLoader(paths, BATCH, max_frames=S, max_channels=CH)
        t0 = time.perf_counter()
        for audio, lens in loader:
            if audio.shape[0] < BATCH:
                continue
            total += float(decode(process(jax.device_put(audio), w)).sum())
        t_seq = time.perf_counter() - t0
        loader.close()

    audio_secs = nb * BATCH * SECS

    print(f"corpus: {n_utts} utts x {CH} ch x {SECS:.0f} s  "
          f"(generated in {t_gen:.1f}s)")
    print(f"per-batch stage costs: load {t_load*1e3:.0f} ms | upload "
          f"{t_up*1e3:.0f} ms | beamform+features+decode {t_comp*1e3:.1f} ms")
    print(f"pipelined wall: {t_pipe:.2f}s for {audio_secs:.0f} audio-s "
          f"({audio_secs/t_pipe:.1f} audio-s/s sustained)")
    print(f"sequential baseline: {t_seq:.2f}s "
          f"({audio_secs/t_seq:.1f} audio-s/s) -> pipelining gains "
          f"{t_seq/t_pipe:.2f}x")
    print(f"device-side compute alone: {BATCH*SECS/t_comp:.0f} audio-s/s")
    return total


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
