"""Config-5 experiment: JOINT neural-beamformer + Conformer-CTC training
on the image-source reverberant corpus (round-4 VERDICT item 3).

Three systems, identical AM init and training schedule:
  joint     — CTC loss backpropagates into BOTH the mask-MVDR front-end
              and the Conformer AM (models/joint.py);
  untrained — the mask estimator stays at random init; only the AM trains;
  oracle    — frozen oracle-steered MVDR front-end (true source position
              + diffuse coherence); only the AM trains.

Reports greedy WER on held-out reverberant utterances and the SI-SDR of
each front-end's enhanced waveform against the clean source.  The gates
frozen into tests/test_joint_ctc.py come from this table.

Run: python tools/exp_joint_ctc.py   (CPU is fine)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

SR = 16000.0
ROOM = np.array([5.0, 4.0, 3.0])
CENTER = np.array([2.0, 1.0, 1.2])
SRCPOS = np.array([0.6, 1.5, 0.3])
REFLECT = 0.7
ORDER = 2
SNR_DB = 25.0
DIFFUSE_DB = 3.0
N_CH = 6
STEPS = int(os.environ.get("STEPS", "150"))
N_TRAIN = int(os.environ.get("N_TRAIN", "20"))
N_EVAL = int(os.environ.get("N_EVAL", "12"))


def build_data(jnp, jfb, cfg, n_utts, seed):
    """Reverberant multi-channel corpus → (X (B,N,T,K) c64, labels,
    label_lens, word lists, clean/enhref waveforms)."""
    from golden import corpus as gcorpus
    from golden import room as groom
    from dsr.config import ArrayGeometry

    POS = np.asarray(ArrayGeometry.circular(N_CH, 0.10).positions)
    corpus = gcorpus.make_corpus(n_utts, min_words=1, max_words=1, seed=seed)
    vocab = gcorpus.VOCAB
    widx = {w: i + 1 for i, w in enumerate(vocab)}    # CTC ids, blank 0
    rng = np.random.default_rng(seed + 1)
    xs, cleans, labels, words = [], [], [], []
    for ws, x in corpus:
        xm = groom.simulate(x, POS, SRCPOS, SR, snr_db=SNR_DB,
                            diffuse_snr_db=DIFFUSE_DB, rng=rng,
                            room_dim=ROOM, array_center=CENTER,
                            reflect=REFLECT, max_order=ORDER).astype(np.float32)
        clean = groom.simulate(x, POS[:1], SRCPOS, SR, snr_db=None,
                               room_dim=ROOM, array_center=CENTER,
                               reflect=0.0, max_order=0)[0]
        xs.append(xm)
        cleans.append(clean.astype(np.float32))
        labels.append([widx[w] for w in ws])
        words.append(ws)
    S = max(x.shape[-1] for x in xs)
    S = ((S + cfg.D - 1) // cfg.D) * cfg.D
    xm_pad = np.zeros((len(xs), N_CH, S), np.float32)
    for i, x in enumerate(xs):
        xm_pad[i, :, : x.shape[-1]] = x
    A = jfb.analysis(jnp.asarray(xm_pad), cfg)            # (B, N, T, K)
    L = max(len(l) for l in labels)
    lab = np.zeros((len(labels), L), np.int32)
    lens = np.zeros(len(labels), np.int32)
    for i, l in enumerate(labels):
        lab[i, : len(l)] = l
        lens[i] = len(l)
    return A, lab, lens, words, xm_pad, cleans, POS


def greedy_words(logits, vocab):
    from dsr.models.conformer import greedy_ctc_decode
    ids = greedy_ctc_decode(logits)
    return [vocab[i - 1] for i in ids if 1 <= i <= len(vocab)]


def wer(ref_lists, hyp_lists):
    from dsr.utils.metrics import WerScorer
    sc = WerScorer()
    for r, h in zip(ref_lists, hyp_lists):
        sc.add(r, h)
    return sc.wer


def main():
    import jax
    if os.environ.get("JOINT_FULL") != "1":
        # this study is CPU-sized (set JOINT_FULL=1 to run on the GPU)
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from golden import corpus as gcorpus
    from dsr.config import FilterbankConfig
    from dsr.models import joint as mj
    from dsr.ops import beamforming as jbf
    from dsr.ops import filterbank as jfb
    from dsr.utils import objective as obj
    from golden import room as groom

    cfg = FilterbankConfig(M=64, m=2, r=2)
    vocab = gcorpus.VOCAB
    Xtr, lab_tr, len_tr, words_tr, _, _, POS = build_data(
        jnp, jfb, cfg, N_TRAIN, seed=0)
    Xev, lab_ev, len_ev, words_ev, xm_ev, clean_ev, _ = build_data(
        jnp, jfb, cfg, N_EVAL, seed=500)
    print(f"train X {Xtr.shape}, eval X {Xev.shape}", flush=True)

    model = mj.JointBeamformerCtc(vocab=len(vocab), subbands_m=cfg.M)
    params0 = model.init(jax.random.PRNGKey(0), Xtr[:1])
    # clip: late-training gradients through the masked-PSD MVDR solve can
    # spike once masks saturate (an unclipped 1500-step run went NaN)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(3e-3))

    # oracle MVDR weights from the true geometry
    taus = (groom.steering_delays(POS, SRCPOS, 343.0, SR) / SR).astype(np.float32)
    v = jbf.steering_vectors(jnp.asarray(taus), cfg.M, SR)
    Gamma = jbf.diffuse_coherence(POS, cfg.M, SR, 343.0)
    w_mvdr = jbf.mvdr_weights(v, Gamma, 1e-2)
    omodel = mj.OracleMvdrCtc(vocab=len(vocab), subbands_m=cfg.M)
    oparams0 = omodel.init(jax.random.PRNGKey(0), Xtr[:1], w_mvdr)

    results = {}
    for name in ("joint", "untrained", "oracle"):
        t0 = time.time()
        if name == "oracle":
            def lossf(p, X, lb, ln):
                lg = omodel.apply(p, X, w_mvdr)
                from dsr.models.conformer import ctc_loss
                return ctc_loss(lg, jnp.full((lg.shape[0],), lg.shape[1],
                                             jnp.int32), lb, ln)

            @jax.jit
            def ostep(p, o, X, lb, ln):
                l, g = jax.value_and_grad(lossf)(p, X, lb, ln)
                u, o = tx.update(g, o, p)
                return optax.apply_updates(p, u), o, l
            p, o = oparams0, tx.init(oparams0)
            for s in range(STEPS):
                p, o, l = ostep(p, o, Xtr, jnp.asarray(lab_tr),
                                jnp.asarray(len_tr))
                if s % 100 == 0:
                    print(f"  {name} step {s} loss {float(l):.3f}", flush=True)
            logits = omodel.apply(p, Xev, w_mvdr)
        else:
            step = mj.make_train_step(model, tx,
                                      frozen_frontend=(name == "untrained"))
            p, o = params0, tx.init(params0)
            for s in range(STEPS):
                p, o, l = step(p, o, Xtr, jnp.asarray(lab_tr),
                               jnp.asarray(len_tr))
                if s % 100 == 0:
                    print(f"  {name} step {s} loss {float(l):.3f}", flush=True)
            logits = model.apply(p, Xev)
        hyps = [greedy_words(np.asarray(logits[i]), vocab)
                for i in range(len(words_ev))]
        w = wer(words_ev, hyps)
        # front-end SI-SDR on eval utt 0 (joint/untrained only)
        sisdr = None
        if name != "oracle":
            from dsr.models.neural_beamformer import NeuralBeamformer
            nb_params = {"params": p["params"]["frontend"]}
            enh = NeuralBeamformer(model.hidden).apply(nb_params, Xev[0])
            y = np.asarray(jfb.synthesis(enh, cfg, xm_ev.shape[-1]))
            n = min(len(clean_ev[0]), len(y))
            sisdr = float(obj.si_sdr(y[:n], clean_ev[0][:n]))
        results[name] = (w, sisdr, float(l))
        print(f"{name:10s} WER {100*w:6.2f}%  final loss {float(l):7.3f}  "
              f"si_sdr {sisdr}  [{time.time()-t0:.0f}s]", flush=True)

    print("\n| system | WER% | front-end SI-SDR (dB) | final CTC loss |")
    print("|---|---|---|---|")
    for k, (w, s, l) in results.items():
        print(f"| {k} | {100*w:.2f} | {'-' if s is None else f'{s:.2f}'} "
              f"| {l:.3f} |")


if __name__ == "__main__":
    main()
