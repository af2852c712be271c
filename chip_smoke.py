"""Smoke run of the main path on one NVIDIA GPU, at full width.

Phases, each printing one line (a phase that fails raises and the script
exits non-zero):

  1. device     — JAX's devices; the card's name and power limit
  2. beamform   — DsrPipeline, 64-channel MVDR, M=256 m=4 r=2, one 8 s
                  buffer: analysis and MVDR output against `golden/`, the
                  analysis→synthesis round trip, warmed time per buffer
  3. monophone  — the ~0.5M-state trigram HCLG: degree-split decode
                  (a0=2, kcap=256, eg=896) of 8 x 1000 frames equals the
                  dense decode, and in-domain utterances decode at 0 WER
  4. triphone   — the 213k-state tied-triphone HCLG: the same checks at
                  a0=4, kcap=512, eg=640

and a last line {"ok": true, "device": {...}}.

    python chip_smoke.py               # one card, phases 1-4
    python chip_smoke.py --four-cards  # four cards: graph-sharded decode
                                       # vs one card, data-parallel GMM
                                       # step vs one device

Without a GPU it fails; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

SR = 16000.0
U, T_FRAMES = 8, 1000            # decode batch: 8 utterances x 8 s at 125 fps
REPS = 5


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def timed(fn, reps=REPS):
    """Warm `fn` once, then time `reps` calls ending in block_until_ready
    → (result, mean s, min s, max s)."""
    import jax

    out = jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, float(np.mean(ts)), min(ts), max(ts)


def peak_gb(dev):
    return dev.memory_stats()["peak_bytes_in_use"] / 1e9


def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu",
          f"no GPU: JAX's default device is {d.platform} ({d.device_kind})")
    check(len(devs) >= n_cards, f"needs {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)} jax={jax.__version__}")
    print(f"card: {smi.splitlines()[0]}")
    return devs


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


def phase_beamform(dev):
    import jax.numpy as jnp

    from dsr.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
    from dsr.ops import beamforming as jbf
    from dsr.ops import filterbank as jfb
    from dsr.pipeline import DsrPipeline
    from golden import beamforming as gbf
    from golden import filterbank as gfb
    from golden import room as groom

    cfg = FilterbankConfig(M=256, m=4, r=2)
    geom = ArrayGeometry.circular(64, 0.20)
    pipe = DsrPipeline(fb=cfg, geometry=geom,
                       beamformer=BeamformerConfig(kind="mvdr"))
    src = np.array([0.0, 2.0, 0.0])
    rng = np.random.default_rng(0)
    S = int(8 * SR)
    # a seeded, speech-band-coloured source rendered onto the array
    s = np.convolve(rng.standard_normal(S), np.hanning(9), mode="same")
    x = groom.simulate(s, np.asarray(geom.positions), src, SR, snr_db=20.0,
                       rng=rng).astype(np.float32)

    (y, feats), t, tmin, tmax = timed(lambda: pipe.process(x, src))
    check(y.shape == (S,) and np.isfinite(np.asarray(y)).all(),
          f"enhanced waveform {y.shape} not finite")
    check(np.isfinite(np.asarray(feats)).all(), "features not finite")

    # analysis and MVDR output against the golden NumPy (float64) path
    A = jfb.analysis(jnp.asarray(x), cfg)
    Y, _ = pipe.beamform_subbands(A, src)
    hf = jfb.get_prototypes(cfg)[0]
    chans = range(0, 64, 8)
    A_ref = np.stack([gfb.analysis(x[c].astype(np.float64), hf, cfg.M, cfg.r)
                      for c in range(64)])
    err_a = max(_rel(np.asarray(A)[c], A_ref[c]) for c in chans)
    taus = pipe.steering_delays(src).astype(np.float64)
    v = gbf.steering_vectors(taus, cfg.M, SR)
    Gamma = gbf.diffuse_coherence(np.asarray(geom.positions), cfg.M, SR,
                                  geom.sound_speed)
    w_ref = gbf.mvdr_weights(v, Gamma, pipe.beamformer.diagonal_loading)
    Y_ref = gbf.apply_weights(A_ref, w_ref)
    err_y = _rel(Y, Y_ref)
    tol_a, tol_y = 1e-5, 1e-3
    check(err_a < tol_a, f"analysis rel err {err_a:.2e} >= {tol_a}")
    check(err_y < tol_y, f"MVDR output rel err {err_y:.2e} >= {tol_y}")

    # perfect-reconstruction round trip on one channel
    yr = np.asarray(jfb.synthesis(A[0], cfg, S))
    rt_db = 20 * np.log10(np.max(np.abs(yr - x[0])) / np.max(np.abs(x[0])))
    check(rt_db < -50.0, f"round trip {rt_db:.1f} dB >= -50 dB")
    print(f"beamform: 64ch MVDR M=256 m=4 r=2, 8 s buffer: "
          f"{t * 1e3:.3f} ms/buffer (min {tmin * 1e3:.3f}, max "
          f"{tmax * 1e3:.3f}, {REPS} reps) = {8.0 / t:.1f} audio-s/s; "
          f"vs golden float64 (complex64, default matmul precision): "
          f"analysis max rel err {err_a:.2e} < {tol_a}, MVDR output "
          f"{err_y:.2e} < {tol_y}; round trip {rt_db:.1f} dB < -50; "
          f"peak {peak_gb(dev):.2f} GB")


def in_domain_batch(task, synth, words_per_sent):
    """U in-domain utterances (sentences of the LM's own training text)
    padded to T_FRAMES → (sentences, feats (U, T, D), lengths (U,))."""
    from dsr.asr import lvcsr

    cfg = task.cfg
    rng0 = np.random.default_rng(cfg.seed)      # build_task's rng stream
    lex = lvcsr.make_lexicon(cfg.vocab_size, rng0)
    text = lvcsr.make_text(sorted(lex), cfg.n_tokens, cfg.branching, rng0)
    sents = [s[:words_per_sent] for s in text[:U]]
    rng = np.random.default_rng(5)
    fs = [synth(task, s, rng) for s in sents]
    check(max(len(f) for f in fs) <= T_FRAMES, "utterance longer than T")
    feats = np.zeros((U, T_FRAMES, fs[0].shape[1]), np.float32)
    for i, f in enumerate(fs):
        feats[i, :len(f)] = f
    return sents, feats, np.asarray([len(f) for f in fs], np.int32)


def phase_decode(dev, name, build, a0, kcap, eg, beam, am, synth, wps):
    import jax.numpy as jnp

    from dsr.asr.am import gmm as jgmm
    from dsr.asr.decoder import split_decoder as sd
    from dsr.asr.decoder import topk_decoder as tk

    t0 = time.perf_counter()
    task = build()
    sg = sd.build_split_graph(task.graph, a0=a0)
    tg = tk.build_token_graph(task.graph)
    t_setup = time.perf_counter() - t0

    sents, feats, lens = in_domain_batch(task, synth, wps)
    ll = jgmm.loglik(am(task), jnp.asarray(feats))
    lens_d = jnp.asarray(lens)
    (o_s, sc_s, ovf), t, tmin, tmax = timed(
        lambda: sd.decode_batch_split(sg, ll, lens_d, kcap=kcap, beam=beam,
                                      eg=eg))
    o_d, sc_d = tk.decode_batch(tg, ll, lens_d, kcap=kcap, beam=beam)
    o_s, o_d = np.asarray(o_s), np.asarray(o_d)
    dscore = float(np.max(np.abs(np.asarray(sc_s) - np.asarray(sc_d))))
    n_ovf = int(np.asarray(ovf).sum())
    check(n_ovf == 0, f"{n_ovf} overflow frames")
    check(np.array_equal(o_s, o_d), "split olabels != dense olabels")
    check(dscore < 1e-3, f"split vs dense score diff {dscore:.2e}")
    errs = 0
    for i, s in enumerate(sents):
        hyp = [task.words.name(int(w)) for w in o_s[i][:lens[i]] if w]
        errs += hyp != s
    check(errs == 0, f"{errs}/{U} in-domain utterances decoded wrong")
    audio = float(lens.sum()) / 125.0
    print(f"{name}: {task.graph.num_states} states / "
          f"{len(task.graph.src)} arcs, set-up {t_setup:.1f} s; split "
          f"a0={a0} kcap={kcap} eg={eg} beam={beam}, U={U} x T={T_FRAMES}: "
          f"{t * 1e3:.1f} ms/batch (min {tmin * 1e3:.1f}, max "
          f"{tmax * 1e3:.1f}, {REPS} reps) = {U * T_FRAMES / 125.0 / t:.1f} "
          f"audio-s/s padded ({audio / t:.1f} real); split == dense "
          f"(olabels equal, max score diff {dscore:.1e} < 1e-3); "
          f"overflow frames 0; in-domain WER 0/{U}; peak "
          f"{peak_gb(dev):.2f} GB")


def run_one_card():
    from dsr.asr import lvcsr

    devs = phase_device(1)
    phase_beamform(devs[0])
    phase_decode(devs[0], "monophone",
                 lambda: lvcsr.build_task(lvcsr.LvcsrConfig()),
                 a0=2, kcap=256, eg=896, beam=40.0, am=lvcsr.synthetic_am,
                 synth=lvcsr.synthesize_utterance, wps=5)
    phase_decode(devs[0], "triphone", lvcsr.build_task_tri,
                 a0=4, kcap=512, eg=640, beam=60.0, am=lvcsr.synthetic_am_tri,
                 synth=lvcsr.synthesize_utterance_tri, wps=3)
    return devs


def run_four_cards():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from __graft_entry__ import gmm_train_step
    from dsr.asr import lvcsr
    from dsr.asr.am import gmm as jgmm
    from dsr.asr.decoder import topk_decoder as tk
    from dsr.config import MeshConfig
    from dsr.parallel import make_mesh
    from dsr.parallel.decoder import make_sharded_decode

    devs = phase_device(4)
    task = lvcsr.build_task(lvcsr.LvcsrConfig())
    tg = tk.build_token_graph(task.graph)
    sents, feats, lens = in_domain_batch(task, lvcsr.synthesize_utterance, 5)
    ll = np.asarray(jgmm.loglik(lvcsr.synthetic_am(task), jnp.asarray(feats)))
    kcap, beam = 256, 40.0
    mesh = make_mesh(MeshConfig(data=1, model=4), devs[:4])
    run = make_sharded_decode(mesh, tg, kcap=kcap, beam=beam)
    (o_sh, sc_sh), t, tmin, tmax = timed(lambda: run(ll, lens))
    o_1, sc_1 = tk.decode_batch(tg, jnp.asarray(ll), jnp.asarray(lens),
                                kcap=kcap, beam=beam)
    dscore = float(np.max(np.abs(np.asarray(sc_sh) - np.asarray(sc_1))))
    check(np.array_equal(np.asarray(o_sh), np.asarray(o_1)),
          "sharded olabels != single-card olabels")
    check(dscore < 1e-3, f"sharded vs single score diff {dscore:.2e}")
    print(f"sharded decode: {tg.num_states}-state monophone HCLG over "
          f"model=4, U={U} x T={T_FRAMES}, kcap={kcap}: {t * 1e3:.1f} "
          f"ms/batch (min {tmin * 1e3:.1f}, max {tmax * 1e3:.1f}); == "
          f"single card (olabels equal, max score diff {dscore:.1e})")

    p4, S0 = gmm_train_step(
        Mesh(np.asarray(devs[:4]).reshape(2, 2, 1),
             ("data", "model", "subband")), U=4)
    p1, _ = gmm_train_step(
        Mesh(np.asarray(devs[:1]).reshape(1, 1, 1),
             ("data", "model", "subband")), U=4)
    err = max(float(np.max(np.abs(np.asarray(a)[:S0] - np.asarray(b)[:S0])))
              for a, b in zip(p4, p1))
    check(err < 1e-2, f"4-card GMM step differs from 1 device by {err:.2e}")
    print(f"data-parallel GMM step: mesh data=2 x model=2 == one device "
          f"(max abs param diff {err:.1e} < 1e-2)")
    return devs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded paths")
    args = ap.parse_args()
    devs = run_four_cards() if args.four_cards else run_one_card()
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}))


if __name__ == "__main__":
    main()
