"""Benchmark: beamformed audio-sec/s plus LVCSR decode throughput, with
roofline accounting, as one JSON line on one GPU.

Cells:
  - beamform: 64-channel circular array, oversampled subband analysis
    (M=256, m=4, r=2) → superdirective MVDR apply → synthesis, one jitted
    program per 8 s buffer;
  - monophone decode: the ~0.5M-state trigram HCLG through the
    degree-split decoder (a0=2, kcap=256, eg=896), 8 utterances x 1000
    frames;
  - triphone decode: the 213k-state tied-triphone HCLG, degree-split
    a0=4, kcap=512, eg=640 (plus a kcap=256, eg=384 row).

Timing: every program is compiled and warmed first (calls for at least
WINDOW_S); then REPS windows, each of as many back-to-back calls as fill
WINDOW_S and ending in `block_until_ready`, are timed on the host clock;
the time per call is reported with its spread over the windows.  Inputs are device-resident and MVDR weights
precomputed (they depend on geometry and steering only).  The decoder is a
fixed-shape lax.scan, so random log-likelihoods measure its throughput.

Roofline: the least time the card could take, max(bytes / peak bytes/s,
FLOPs / peak FLOP/s), over the measured time, with the bytes and FLOPs the
XLA path needs computed from shapes below.  Peaks come from the table keyed
by `device_kind`; a device not in it is an error.

    python bench.py                # one JSON line
    python bench.py --trace DIR    # also trace one warmed window per cell
                                   # and print device time per layer
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

# NVIDIA's H100 SXM data sheet: dense rates, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12, "fp32_flops": 67e12,
                              "tf32_flops": 495e12, "bf16_flops": 989e12},
}
REPS = 5
WINDOW_S = 0.25


def peaks_for(dev):
    if dev.device_kind not in PEAKS:
        raise KeyError(f"no peak table entry for device kind "
                       f"{dev.device_kind!r}; add its data-sheet peaks")
    return PEAKS[dev.device_kind]


def timed(jax, fn, reps=None):
    """Compile and warm `fn`, then time `reps` windows of back-to-back
    calls → (last output, [seconds per call in each window], calls per
    window)."""
    reps = reps or REPS
    out = jax.block_until_ready(fn())
    n, t0 = 0, time.perf_counter()
    while n < 3 or time.perf_counter() - t0 < WINDOW_S:
        out = jax.block_until_ready(fn())
        n += 1
    calls = max(1, round(n * WINDOW_S / (time.perf_counter() - t0)))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn()
        out = jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / calls)
    return out, ts, calls


def roofline(bytes_moved, flops, seconds, peak):
    t_bw = bytes_moved / peak["hbm_bytes_s"]
    t_fl = flops / peak["fp32_flops"]
    return {"bytes": int(bytes_moved), "flops": int(flops),
            "t_bw_us": t_bw * 1e6, "t_flops_us": t_fl * 1e6,
            "bound": "hbm" if t_bw >= t_fl else "fp32",
            "fraction_of_roofline": max(t_bw, t_fl) / seconds}


def bench_beamform(jax, jnp, peak):
    from dsr.config import ArrayGeometry, FilterbankConfig
    from dsr.ops import beamforming as jbf
    from dsr.ops import features as jft
    from dsr.ops import filterbank as jfb
    from golden import room as groom

    SR = 16000.0
    cfg = FilterbankConfig(M=256, m=4, r=2)
    N, NBUF, secs = 64, 8, 8.0
    S = int(SR * secs)
    POS = np.asarray(ArrayGeometry.circular(N, 0.20).positions)
    taus = (groom.steering_delays(POS, np.array([0.0, 2.0, 0.0]), 343.0, SR)
            / SR).astype(np.float32)
    Ginv = jbf.mvdr_precompute(jbf.diffuse_coherence(POS, cfg.M, SR, 343.0))
    w = jbf.mvdr_weights_from_inv(
        jbf.steering_vectors(jnp.asarray(taus), cfg.M, SR), Ginv)
    xs = jax.device_put(np.random.default_rng(0).standard_normal(
        (NBUF, N, S)).astype(np.float32))
    hf, gf, delay = jfb.get_prototypes(cfg)
    hf, gf = jnp.asarray(hf, jnp.float32), jnp.asarray(gf, jnp.float32)

    @jax.jit
    def pipeline(xs, i, w):
        A = jfb.analysis(xs[i], cfg, hf)
        return jfb.synthesis(jbf.apply_weights(A, w), cfg, S, gf, delay)

    @jax.jit
    def with_features(xs, i, w):
        """The traced program: the pipeline plus the MFCC of the beamformed
        subbands, as DsrPipeline.process computes them."""
        Y = jbf.apply_weights(jfb.analysis(xs[i], cfg, hf), w)
        return (jfb.synthesis(Y, cfg, S, gf, delay),
                jft.mfcc_from_subbands(Y, cfg.M, SR))

    state = {"i": 0}

    def one():
        state["i"] = (state["i"] + 1) % NBUF
        return pipeline(xs, state["i"], w)

    _, ts, calls = timed(jax, one)
    dt = float(np.mean(ts))
    # bytes the XLA path must move: the signal in, the (N, T, K) complex64
    # spectra out of analysis and back into the apply, the beamformed
    # spectra and the waveform out
    T, K = jfb.num_frames(S, cfg), cfg.num_bins
    bytes_moved = N * S * 4 + 2 * N * T * K * 8 + 2 * T * K * 8 + S * 4
    # FLOPs: window + fold (2 per tap), rFFT (~2.5 M log2 M per frame),
    # complex apply (8 per channel-bin), synthesis IFFT + window + OLA
    lg = int(np.log2(cfg.M))
    flops = (N * T * (2 * cfg.L + 2.5 * cfg.M * lg) + 8 * N * T * K
             + T * (2.5 * cfg.M * lg + 2 * cfg.L))
    return {
        "audio_sec_per_s": secs / dt,
        "audio_sec_per_s_reps": sorted(secs / t for t in ts),
        "ms_per_8s_buffer": dt * 1e3,
        "calls_per_window": calls,
        "roofline": roofline(bytes_moved, flops, dt, peak),
    }, (with_features, (xs, 0, w))


def _decode_cell(jax, jnp, peak, sg, num_pdfs, kcap, eg, beam):
    """Degree-split decode of 8 x 1000 random-loglik frames as one jitted
    program (graph tables ride as arguments, not constants)."""
    from dsr.asr.decoder import split_decoder as sd

    U, T = 8, 1000
    ll = jax.device_put(np.random.default_rng(0).standard_normal(
        (U, T, num_pdfs)).astype(np.float32))
    lens = jax.device_put(np.full(U, T, np.int32))
    arrays, meta = sg[:6], sg[6:]

    @jax.jit
    def run(arrays, ll, lens):
        g = sd.SplitTokenGraph(*arrays, *meta)
        return sd.decode_batch_split(g, ll, lens, kcap=kcap, beam=beam, eg=eg)

    out, ts, calls = timed(jax, lambda: run(arrays, ll, lens))
    dt = float(np.mean(ts))
    audio = U * T / 125.0
    a0 = sg.a0
    # per frame and utterance: the token rows and overflow-group rows
    # gathered, the loglik row, the token planes written
    row_bytes = (kcap * (3 * a0 + 2) + eg * 3 * a0) * 4
    bytes_moved = T * U * (row_bytes + num_pdfs * 4 + 3 * kcap * 4)
    return {
        "audio_sec_per_s": audio / dt,
        "audio_sec_per_s_reps": sorted(audio / t for t in ts),
        "ms_per_batch": dt * 1e3,
        "calls_per_window": calls,
        "overflow_frames": int(np.asarray(out[2]).sum()),
        "roofline": roofline(bytes_moved, 0, dt, peak),
        "graph": {"states": sg.num_states, "overflow_groups": sg.num_groups,
                  "a0": a0, "kcap": kcap, "eg": eg, "beam": beam},
    }, (run, (arrays, ll, lens))


def bench_decode(jax, jnp, peak):
    from dsr.asr import lvcsr
    from dsr.asr.decoder import split_decoder as sd

    task = lvcsr.build_task(lvcsr.LvcsrConfig())
    sg = sd.build_split_graph(task.graph, a0=2)
    res, prog = _decode_cell(jax, jnp, peak, sg, task.num_pdfs, 256, 896,
                             40.0)
    res["graph"]["arcs"] = int(task.build_stats["num_arcs"])
    return res, prog


def bench_decode_tri(jax, jnp, peak):
    from dsr.asr import lvcsr
    from dsr.asr.decoder import split_decoder as sd

    task = lvcsr.build_task_tri()
    sg = sd.build_split_graph(task.graph, a0=4)
    res, prog = _decode_cell(jax, jnp, peak, sg, task.num_pdfs, 512, 640,
                             60.0)
    res256, _ = _decode_cell(jax, jnp, peak, sg, task.num_pdfs, 256, 384,
                             60.0)
    res["kcap256_eg384_audio_sec_per_s"] = res256["audio_sec_per_s"]
    return res, prog


def trace_layers(jax, name, prog, out_dir, seconds_per_call):
    """REPS calls of `prog` under the profiler → device seconds per layer
    and call (utils/profiling.layer_times), and the device's idle share:
    1 - device busy per call / the untraced host time per call (tracing
    slows the host, so the traced window's own wall time would inflate
    it)."""
    from dsr.utils import profiling

    fn, args = prog
    text = fn.lower(*args).compile().as_text()
    jax.block_until_ready(fn(*args))
    d = os.path.join(out_dir, name)
    with profiling.trace(d):
        for _ in range(REPS):
            jax.block_until_ready(fn(*args))
    with open(os.path.join(d, "hlo.txt"), "w") as f:
        f.write(text)
    out = {k: v / REPS
           for k, v in profiling.layer_times(d, {name: text}).items()}
    out["idle_share"] = 1.0 - profiling.device_busy(d) / REPS / seconds_per_call
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", metavar="DIR",
                    help="also write a profiler trace per cell under DIR "
                         "and report device seconds per layer")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX's default device is "
                         f"{dev.platform}")
    peak = peaks_for(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    cells = {}
    for name, fn in (("beamform", bench_beamform), ("decode_mono", bench_decode),
                     ("decode_tri", bench_decode_tri)):
        res, prog = fn(jax, jnp, peak)
        if args.trace:
            per_call = (res.get("ms_per_8s_buffer")
                        or res["ms_per_batch"]) / 1e3
            res["layer_device_s"] = trace_layers(jax, name, prog, args.trace,
                                                 per_call)
        cells[name] = res
    cells["peak_bytes_in_use"] = dev.memory_stats()["peak_bytes_in_use"]
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
        "metric": "beamformed audio-sec/s (64ch MVDR, M=256 subband)",
        "value": cells["beamform"]["audio_sec_per_s"],
        "unit": "audio-sec/s",
        "cells": cells,
    }))


if __name__ == "__main__":
    main()
