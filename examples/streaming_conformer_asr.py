"""Streaming Conformer-CTC ASR demo (round-4 VERDICT item 6): train a
small chunk-causal Conformer-CTC on the synthetic small-vocab corpus,
then recognise a multi-channel reverberant utterance INCREMENTALLY —
audio chunks → MVDR beamformed subbands → features → streaming conformer
steps → words printed as they are emitted, equal to the offline
chunk-causal decode (the CTC analogue of examples/streaming_asr.py's
WFST path).

Run: python examples/streaming_conformer_asr.py  (CPU ok)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    if os.environ.get("STREAM_FULL") != "1":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import optax

    from golden import corpus as gcorpus
    from golden import room as groom
    from dsr.config import (ArrayGeometry, BeamformerConfig,
                                FilterbankConfig)
    from dsr.models.streaming_conformer import StreamingConformerCtc
    from dsr.ops import features as jft
    from dsr.ops import filterbank as jfb
    from dsr.pipeline import DsrPipeline, StreamingCtcRecognizer

    SR = 16000.0
    vocab = gcorpus.VOCAB
    widx = {w: i + 1 for i, w in enumerate(vocab)}

    # ---- train on clean single-channel features -------------------------
    fbcfg = FilterbankConfig(M=64, m=4, r=2)
    model = StreamingConformerCtc(vocab=len(vocab), dim=48, layers=2,
                                  heads=2, chunk=8, left=2, feat_dim=13)

    def feats_of(x):
        A = jfb.analysis(jnp.asarray(x, jnp.float32), fbcfg)
        return np.asarray(jft.mfcc_from_subbands(A, fbcfg.M, SR))

    corpus = gcorpus.make_corpus(50, min_words=1, max_words=2, seed=0)
    fcat = np.concatenate([feats_of(x) for _, x in corpus[:10]])
    gmean = np.mean(fcat, axis=0)
    gstd = np.std(fcat, axis=0) + 1e-3     # global feature normalisation
    T = max(feats_of(x).shape[0] for _, x in corpus)
    T = ((T + 31) // 32) * 32
    # noise padding: EXACT-zero rows make the zero-variance LayerNorm
    # Jacobians explode through the depth (measured inf grad norms)
    rngp = np.random.default_rng(99)
    F = rngp.standard_normal((len(corpus), T, 13)).astype(np.float32) * 0.01
    lab = np.zeros((len(corpus), 2), np.int32)
    lens = np.zeros(len(corpus), np.int32)
    flens = np.zeros(len(corpus), np.int32)    # valid SUBSAMPLED frames
    for i, (ws, x) in enumerate(corpus):
        f = (feats_of(x) - gmean) / gstd
        F[i, : f.shape[0]] = f
        flens[i] = (f.shape[0] - 7) // 4 + 1
        ids = [widx[w] for w in ws]
        lab[i, : len(ids)] = ids
        lens[i] = len(ids)

    params = model.init(jax.random.PRNGKey(0), jnp.asarray(F[0]))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(3e-3))
    opt = tx.init(params)
    batched = jax.vmap(lambda p, f: model.apply(p, f), in_axes=(None, 0))

    @jax.jit
    def step(p, o, F, lab, lens, flens):
        def loss_fn(p):
            lg = batched(p, F)
            B, Tl = lg.shape[0], lg.shape[1]
            pad = (jnp.arange(Tl)[None, :] >= flens[:, None]).astype(jnp.float32)
            lpad = (jnp.arange(2)[None, :] >= lens[:, None]).astype(jnp.float32)
            return jnp.mean(optax.ctc_loss(lg, pad, lab, lpad))
        l, g = jax.value_and_grad(loss_fn)(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, l

    Fj, labj, lensj = jnp.asarray(F), jnp.asarray(lab), jnp.asarray(lens)
    flensj = jnp.asarray(flens)
    for s in range(int(os.environ.get("STEPS", "1500"))):
        params, opt, loss = step(params, opt, Fj, labj, lensj, flensj)
        if s % 100 == 0:
            print(f"train step {s}: ctc loss {float(loss):.3f}", flush=True)
        if float(loss) < 0.05:
            print(f"converged at step {s}: ctc loss {float(loss):.3f}")
            break

    # ---- stream a reverberant multi-channel utterance -------------------
    pipe = DsrPipeline(fb=fbcfg,
                       geometry=ArrayGeometry.circular(6, 0.10),
                       beamformer=BeamformerConfig(kind="mvdr"))
    POS = np.asarray(pipe.geometry.positions)
    srcpos = np.array([0.6, 1.5, 0.3])
    rng = np.random.default_rng(5)
    ws, x = gcorpus.make_corpus(1, min_words=2, max_words=2, seed=123)[0]
    xm = groom.simulate(x, POS, srcpos, SR, snr_db=25.0, rng=rng,
                        room_dim=np.array([5.0, 4.0, 3.0]),
                        array_center=np.array([2.0, 1.0, 1.2]),
                        reflect=0.3, max_order=1).astype(np.float32)

    rec = StreamingCtcRecognizer(pipe, model, params, srcpos,
                                 cep_mean=gmean, cep_scale=gstd)
    B = 4000
    chunks = [xm[:, i: i + B] for i in range(0, xm.shape[-1], B)]
    print(f"reference: {ws}")
    t_audio = 0.0
    for out in rec.run(iter(chunks)):
        t_audio = rec.state.pos * 4 * fbcfg.D / SR
        print(f"  t={float(t_audio):5.2f}s  partial: "
              f"{[vocab[i - 1] for i in out]}", flush=True)
    words = rec.finish()
    hyp = [vocab[i - 1] for i in words]
    print(f"final: {hyp}")
    assert hyp == list(ws), (hyp, ws)
    print("streaming transcript matches the reference words")


if __name__ == "__main__":
    main()
