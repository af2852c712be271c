"""WER-vs-pruning study at LVCSR scale.

Decodes a synthetic-AM eval set through the 532k-state monophone trigram
HCLG and the tied-triphone HCLG, sweeping the decoder's pruning knobs —
kcap ∈ {128, 256, 512}, beam ∈ {30, 60} on the dense decoder, plus the
degree-split production layout — with the exact lattice oracle as the
floor.  The noise level is chosen so the acoustics are genuinely
ambiguous (nonzero WER), unlike the in-suite 0-WER gates.

Writes the WER table to PRUNING.md; the shipped defaults (kcap=256,
beam=60) are gated against this study by tests/test_prune_defaults.py.

Run: python tools/exp_wer_prune.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

E_UTTS = 24
NOISE = float(os.environ.get("NOISE", "2.6"))   # AM scale 4.0: ambiguous frames
SEED = 17


def make_sentences(task, lvcsr):
    """In-domain sentences (the LM's own training text distribution)."""
    rng0 = np.random.default_rng(task.cfg.seed)
    lex = lvcsr.make_lexicon(task.cfg.vocab_size, rng0)
    text = lvcsr.make_text(sorted(lex), task.cfg.n_tokens,
                           task.cfg.branching, rng0)
    return [text[i][:7] for i in range(E_UTTS)]


def pad_feats(feats):
    """Pad per-utt features to one fixed T (decoders are length-masked;
    one shape = one compile)."""
    T = max(f.shape[0] for f in feats)
    lens = np.asarray([f.shape[0] for f in feats], np.int32)
    batch = np.zeros((len(feats), T, feats[0].shape[1]), np.float32)
    for i, f in enumerate(feats):
        batch[i, : f.shape[0]] = f
    return batch, lens


def wer_of(task, sents, olabs, lens, scorer_cls):
    sc = scorer_cls()
    for i, s in enumerate(sents):
        hyp = [task.words.name(int(w))
               for w in np.asarray(olabs[i][: lens[i]]) if w]
        sc.add(s, hyp)
    return sc.wer


def main():
    import jax.numpy as jnp

    from dsr.asr import lvcsr
    from dsr.asr.am import gmm as jgmm
    from dsr.asr.decoder import lattice as jlat
    from dsr.asr.decoder import split_decoder as sd
    from dsr.asr.decoder import topk_decoder as tk
    from dsr.utils.metrics import WerScorer

    rng = np.random.default_rng(SEED)
    rows = []

    task = lvcsr.build_task(lvcsr.LvcsrConfig())
    tg = tk.build_token_graph(task.graph)
    params = lvcsr.synthetic_am(task, var=NOISE ** 2)
    sents = make_sentences(task, lvcsr)
    batch, lens = pad_feats([
        lvcsr.synthesize_utterance(task, s, rng, noise=NOISE)
        for s in sents])
    llb = jgmm.loglik(params, jnp.asarray(batch.reshape(-1, batch.shape[-1])))
    llb = jnp.reshape(llb, batch.shape[:2] + (task.num_pdfs,))

    # ---- the exact-lattice oracle floor (kcap=512, no beam) -------------
    oracle_tot = ref_tot = 0
    for i in range(len(sents)):
        # padded to the common T (ONE compile; the oracle skips padded
        # frames), length-masked like the batch decodes
        out = tk.decode_with_tokens(tg, llb[i], kcap=512, beam=1e9, nlat=4,
                                    length=int(lens[i]))
        lat = jlat.from_topk(out[2], out[3], out[4], tg, out[5], out[6])
        refids = [task.words[w] for w in sents[i]]
        oracle_tot += lat.oracle_errors(refids)
        ref_tot += len(refids)
    print(f"oracle floor: {oracle_tot}/{ref_tot} = "
          f"{100.0 * oracle_tot / ref_tot:.2f}%", flush=True)

    def record(name, kcap, beam, olabs):
        w = wer_of(task, sents, np.asarray(olabs), lens, WerScorer)
        rows.append((name, kcap, beam, 100.0 * w))
        print(f"{name:28s} kcap={kcap:4d} beam={beam:6.0f}  WER "
              f"{100.0 * w:6.2f}%", flush=True)

    for kcap in (128, 256, 512):
        for beam in (30.0, 60.0):
            record("dense", kcap, beam,
                   tk.decode_batch(tg, llb, lens, kcap=kcap, beam=beam)[0])
    sg = sd.build_split_graph(task.graph, a0=2)
    record("split a0=2 eg=896", 256, 60.0, sd.decode_batch_split(
        sg, llb, lens, kcap=256, beam=60.0, eg=896)[0])

    # ---- triphone graph ------------------------------------------------
    tri_rows = []
    try:
        ttask = lvcsr.build_task_tri()
        ttg = tk.build_token_graph(ttask.graph)
        tparams = lvcsr.synthetic_am_tri(ttask, var=NOISE ** 2)
        rng2 = np.random.default_rng(SEED + 1)
        tsents = make_sentences(ttask, lvcsr)
        tbatch, tlens = pad_feats([
            lvcsr.synthesize_utterance_tri(ttask, s, rng2, noise=NOISE)
            for s in tsents])
        tll = jgmm.loglik(tparams, jnp.asarray(
            tbatch.reshape(-1, tbatch.shape[-1])))
        tll = jnp.reshape(tll, tbatch.shape[:2] + (-1,))
        for kcap in (128, 256, 512):
            olabs, _ = tk.decode_batch(ttg, tll, tlens, kcap=kcap, beam=60.0)
            w = wer_of(ttask, tsents, np.asarray(olabs), tlens, WerScorer)
            tri_rows.append((kcap, 100.0 * w))
            print(f"triphone kcap={kcap:4d}  WER {100.0 * w:6.2f}%",
                  flush=True)
    except Exception as e:
        print("triphone sweep skipped:", repr(e))

    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "PRUNING.md"), "w") as f:
        f.write(
            "# WER vs pruning at LVCSR scale\n\n"
            f"Produced by `tools/exp_wer_prune.py`: "
            f"{E_UTTS} in-domain utterances, synthetic AM at noise="
            f"{NOISE} (scale 4.0 — genuinely ambiguous acoustics), "
            "532k-state trigram HCLG.\n\n"
            f"**Exact lattice oracle floor (kcap=512, nlat=4): "
            f"{100.0 * oracle_tot / ref_tot:.2f}% WER** — the best any "
            "pruning setting could reach on this set.\n\n"
            "| path | kcap | beam | WER % |\n"
            "|---|---|---|---|\n")
        for name, kcap, beam, w in rows:
            f.write(f"| {name} | {kcap} | {beam:.0f} | {w:.2f} |\n")
        if tri_rows:
            f.write("\nTied-triphone HCLG (same protocol):\n\n"
                    "| kcap | WER % |\n|---|---|\n")
            for kcap, w in tri_rows:
                f.write(f"| {kcap} | {w:.2f} |\n")
        f.write(
            "\n## Reading\n\n"
            "- The shipped defaults (kcap=256, beam=60) are gated by "
            "`tests/test_prune_defaults.py`: kcap=256 must be within 1% "
            "absolute WER of kcap=512, and the degree-split decoder must "
            "decode the dense decoder's words at the default operating "
            "point.\n")
    print("wrote PRUNING.md")


if __name__ == "__main__":
    main()
