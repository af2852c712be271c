"""Tied-triphone LVCSR decode study: WER and throughput of the dense
token table against the degree-split layouts.

The triphone HCLG is the realistic context-dependent decode config:
a_max=263 against a MEAN out-degree of 3.9 means the dense token table is
~98.5% padding — 67k/135k scored candidates per frame at kcap=256/512.
The degree-split decoder's pool is (kcap+EG)*a0 instead; this study sweeps
a0 ∈ {8, 4, 2} with the overflow budget EG sized to each, reporting WER,
overflow frames and audio-s/s on the device it runs on.

Run: python tools/exp_tri_decode.py          Optional: NOISE=2.2 E_UTTS=24
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

E_UTTS = int(os.environ.get("E_UTTS", "24"))
NOISE = float(os.environ.get("NOISE", "2.6"))
SEED = 17


def main():
    import jax
    import jax.numpy as jnp

    from dsr.asr import lvcsr
    from dsr.asr.am import gmm as jgmm
    from dsr.asr.decoder import split_decoder as sd
    from dsr.asr.decoder import topk_decoder as tk
    from dsr.utils.metrics import WerScorer
    from tools.exp_wer_prune import make_sentences, pad_feats, wer_of

    task = lvcsr.build_task_tri()
    tg = tk.build_token_graph(task.graph)
    params = lvcsr.synthetic_am_tri(task, var=NOISE ** 2)
    rng = np.random.default_rng(SEED + 1)
    import tools.exp_wer_prune as ewp
    ewp.E_UTTS = E_UTTS          # make_sentences reads the module global
    sents = make_sentences(task, lvcsr)
    batch, lens = pad_feats([
        lvcsr.synthesize_utterance_tri(task, s, rng, noise=NOISE)
        for s in sents])
    ll = jgmm.loglik(params, jnp.asarray(batch.reshape(-1, batch.shape[-1])))
    ll = jnp.reshape(ll, batch.shape[:2] + (-1,))
    lens_j = jnp.asarray(lens)
    audio = float(lens.sum()) / 125.0
    # this script divides by REAL audio seconds, but the fixed-shape scan
    # decodes every PADDED frame of the variable-length batch — so its
    # audio-s/s is the bench.py number x (real frames / padded frames).
    # bench.py (all utterances full-length, zero padding) is the canonical
    # throughput; this script's numbers exist for the WER columns.
    pad_frames = int(np.prod(batch.shape[:2]))
    print(f"padding: {lens.sum()}/{pad_frames} real frames "
          f"({100.0 * float(lens.sum()) / pad_frames:.1f}%) — "
          "audio-s/s below include the padding tax; bench.py is canonical",
          flush=True)
    counts = np.bincount(task.graph.src, minlength=task.graph.num_states)
    print(f"triphone graph: {task.graph.num_states} states, "
          f"{len(task.graph.src)} arcs, a_max={counts.max()}, "
          f"mean deg {counts.mean():.2f}, pdfs={task.num_pdfs}, "
          f"{E_UTTS} utts, noise={NOISE}", flush=True)

    rows = []

    def timeit(fn):
        jax.block_until_ready(fn())              # warmup / compile
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        return out, time.perf_counter() - t0

    def record(name, kcap, olabs, dt, extra=""):
        w = wer_of(task, sents, np.asarray(olabs), lens, WerScorer)
        rows.append((name, kcap, 100.0 * w, audio / dt, extra))
        print(f"{name:24s} kcap={kcap:4d}  WER {100.0 * w:6.2f}%  "
              f"{audio / dt:7.1f} audio-s/s  {extra}", flush=True)

    for kcap in (256, 512):
        (olabs, sc), dt = timeit(lambda: tk.decode_batch(
            tg, ll, lens_j, kcap=kcap, beam=60.0))
        record("dense", kcap, olabs, dt)
    for a0 in (8, 4, 2):
        sg = sd.build_split_graph(task.graph, a0=a0)
        eg = 4096 // a0
        for kcap in (256, 512):
            (olabs, sc, ovf), dt = timeit(lambda: sd.decode_batch_split(
                sg, ll, lens_j, kcap=kcap, beam=60.0, eg=eg))
            record(f"split a0={a0}", kcap, olabs, dt,
                   f"eg={eg} ovf={int(np.asarray(ovf).sum())}")

    print("\n| path | kcap | WER% | audio-s/s | notes |")
    print("|---|---|---|---|---|")
    for name, kcap, w, thr, extra in rows:
        print(f"| {name} | {kcap} | {w:.2f} | {thr:.1f} | {extra} |")


if __name__ == "__main__":
    main()
