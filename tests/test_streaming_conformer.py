"""Streaming Conformer-CTC parity: chunked streaming with carried state
must equal the offline chunk-causal pass (models/streaming_conformer.py;
SURVEY.md §5 long-context — the CTC-path analogue of the WFST decoder's
streaming==offline gate)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytest.importorskip("flax")  # dsr.models needs it; the core does not

from dsr.models.streaming_conformer import (StreamingConformerCtc,
                                                greedy_ctc_stream)


@pytest.fixture(scope="module")
def model_and_params():
    model = StreamingConformerCtc(vocab=7, dim=32, layers=2, heads=2,
                                  chunk=4, left=2, feat_dim=13)
    rng = np.random.default_rng(0)
    feats0 = jnp.asarray(rng.standard_normal((80, 13)), jnp.float32)
    params = model.init(jax.random.PRNGKey(1), feats0)
    return model, params


def test_streamed_equals_offline(model_and_params):
    model, params = model_and_params
    C = model.chunk
    n_chunks = 6
    rng = np.random.default_rng(3)
    feats = jnp.asarray(rng.standard_normal((4 * C * n_chunks, 13)),
                        jnp.float32)
    ref = model.apply(params, feats)                  # (C*n-1, V+1)
    assert ref.shape[0] == C * n_chunks - 1

    state = model.init_state()
    parts = []
    step = jax.jit(lambda p, c, s: model.apply(p, c, s, method="step"))
    for n in range(n_chunks):
        chunk = feats[4 * C * n: 4 * C * (n + 1)]
        logits, n_new, state = step(params, chunk, state)
        parts.append(np.asarray(logits)[: int(n_new)])
    tail, n_tail = model.apply(params, state, method="finish")
    parts.append(np.asarray(tail)[: int(n_tail)])
    got = np.concatenate(parts, axis=0)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-4, rtol=1e-4)
    # the streamed greedy transcript equals the offline one — fed the REAL
    # per-step logit blocks so the cross-chunk prev-label carry is exercised
    ids_off = []
    prev = -1
    for i in np.asarray(jnp.argmax(ref, axis=-1)):
        if i != prev and i != 0:
            ids_off.append(int(i))
        prev = int(i)
    assert sum(len(p) > 0 for p in parts) > 1   # multi-chunk, not degenerate
    assert greedy_ctc_stream([p for p in parts if len(p)]).tolist() == ids_off


def test_streaming_state_is_chunk_local(model_and_params):
    """Changing audio BEFORE the visible context window must not change
    the current chunk's logits (left context is exactly `left` chunks +
    the conv tail)."""
    model, params = model_and_params
    C = model.chunk
    N = 16
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((4 * C * N, 13)).astype(np.float32)
    feats2 = feats.copy()
    feats2[: 4 * C] += 10.0          # perturb ONLY the first raw chunk
    step = jax.jit(lambda p, c, s: model.apply(p, c, s, method="step"))

    def last_logits(f):
        state = model.init_state()
        out = None
        for n in range(N):
            out, n_new, state = step(params, jnp.asarray(f[4*C*n:4*C*(n+1)]),
                                     state)
        return np.asarray(out)

    # the last emitted chunk is #N-2 (frames 56-59); the receptive field
    # per layer is left*C attention + (k-1) conv frames, so 2 layers
    # reach 2*(8+14)=44 frames back — to frame 12, clear of the
    # perturbed subsampled chunk 0 (frames 0-3)
    np.testing.assert_allclose(last_logits(feats), last_logits(feats2),
                               atol=1e-5)


def test_streaming_ctc_recognizer_matches_offline():
    """pipeline.StreamingCtcRecognizer: audio chunks → beamformed
    subbands → features → streaming conformer steps; the incremental
    transcript equals the offline chunk-causal greedy decode on the same
    features (the CTC analogue of StreamingRecognizer's WFST gate)."""
    from golden import room as groom
    from dsr.config import (ArrayGeometry, BeamformerConfig,
                                FilterbankConfig)
    from dsr.ops import features as jft
    from dsr.pipeline import DsrPipeline, StreamingCtcRecognizer

    SR = 16000.0
    rng = np.random.default_rng(7)
    pos = np.array([0.5, 1.2, 0.0])
    pipe = DsrPipeline(
        fb=FilterbankConfig(M=64, m=4, r=2),
        geometry=ArrayGeometry.linear(6, 0.04),
        beamformer=BeamformerConfig(kind="mvdr"),
    )
    POS = np.asarray(pipe.geometry.positions)
    x = rng.standard_normal(int(1.6 * SR))
    xm = groom.simulate(x, POS, pos, SR, snr_db=20.0, rng=rng).astype(np.float32)

    model = StreamingConformerCtc(vocab=9, dim=32, layers=2, heads=2,
                                  chunk=4, left=2,
                                  feat_dim=pipe.frontend.num_cepstra)
    params = model.init(jax.random.PRNGKey(3),
                        jnp.zeros((160, pipe.frontend.num_cepstra)))

    rec = StreamingCtcRecognizer(pipe, model, params, pos,
                                 cep_mean=np.zeros(pipe.frontend.num_cepstra))
    B = 4000
    chunks = [xm[:, i: i + B] for i in range(0, xm.shape[-1], B)]
    inc = []
    for out in rec.run(iter(chunks)):
        inc.extend(out)
    words = rec.finish()
    assert words[: len(inc)] == inc  # finish only appends to the stream

    # offline reference on the SAME feature stream the recognizer
    # consumed: offline beamformed subbands (process_streaming_subbands
    # is frame-exact vs offline) through the recognizer's causal
    # feature path (fixed cep mean, NOT utterance CMN)
    from dsr.ops import filterbank as jfb
    from dsr.ops import beamforming as jbf  # noqa: F401 (pipe internals)
    A = jfb.analysis(jnp.asarray(xm), pipe.fb)
    Y, _ = pipe.beamform_subbands(A, pos)
    feats = rec._feats(Y)
    C4 = 4 * model.chunk
    n_full = (feats.shape[0] // C4) * C4
    ref_logits = model.apply(params, jnp.asarray(feats[:n_full]))
    prev, ref_ids = -1, []
    for i in np.asarray(jnp.argmax(ref_logits, axis=-1)):
        if i != prev and i != 0:
            ref_ids.append(int(i))
        prev = int(i)
    assert words == ref_ids
