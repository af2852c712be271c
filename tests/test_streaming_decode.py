"""Streaming decode gates (SURVEY.md §5 long-context; VERDICT item 7):
the decoder's (states, scores) carry crosses chunk boundaries, so chunked
decoding equals the whole-utterance decode; the full streaming chain
(audio chunks → subband frames → features → decode_chunk → traceback)
matches offline recognition on the config-1 corpus."""

import numpy as np
import jax.numpy as jnp
import pytest

from golden import corpus as gcorpus
from golden import room as groom
from dsr.asr import phone_task
from dsr.asr.am import gmm as jgmm
from dsr.asr.decoder import topk_decoder as tk
from dsr.asr.fsm import hclg, lm
from dsr.asr.fsm.packed import pack, PackedGraph
from dsr.asr.train import trainer
from dsr.config import ArrayGeometry, BeamformerConfig, FilterbankConfig
from dsr.ops import features as jft
from dsr.pipeline import DsrPipeline, StreamingRecognizer

SR = 16000.0


def test_decode_chunk_equals_full_random_graph():
    rng = np.random.default_rng(3)
    S, P, T = 40, 8, 30
    n_arcs = 150
    src = rng.integers(0, S, n_arcs).astype(np.int32)
    dst = rng.integers(0, S, n_arcs).astype(np.int32)
    pdf = rng.integers(0, P, n_arcs).astype(np.int32)
    ola = rng.integers(0, 4, n_arcs).astype(np.int32)
    w = rng.random(n_arcs).astype(np.float32)
    fin = np.where(rng.random(S) < 0.3, 0.0, np.inf).astype(np.float32)
    g = PackedGraph(src, pdf, ola, w, dst, int(src[0]), fin, S)
    tg = tk.build_token_graph(g)
    ll = rng.standard_normal((T, P)).astype(np.float32)
    olabs_full, score_full, ts_, ta_, _ = tk.decode_with_tokens(
        tg, jnp.asarray(ll), kcap=32
    )
    carry = tk.stream_start(tg, kcap=32)
    toks_s, toks_a = [], []
    for lo, hi in ((0, 7), (7, 19), (19, 30)):
        carry, toks = tk.decode_chunk(tg, jnp.asarray(ll[lo:hi]), carry, kcap=32)
        toks_s.append(np.asarray(toks[0]))
        toks_a.append(np.asarray(toks[1]))
    olabs_c, score_c = tk.traceback(
        tg, jnp.asarray(np.concatenate(toks_s)), jnp.asarray(np.concatenate(toks_a)),
        carry,
    )
    np.testing.assert_array_equal(np.asarray(olabs_c), np.asarray(olabs_full))
    assert float(score_c) == pytest.approx(float(score_full), abs=1e-5)
    # token arrays themselves are identical (same scan, chunked carry)
    np.testing.assert_array_equal(np.concatenate(toks_s), np.asarray(ts_))
    # ragged chunk lengths are BUCKETED before jit (every new shape is a
    # compile): the three distinct lengths above (7, 12, 11) share at most
    # two bucket shapes (8 and 16)
    n0 = tk._decode_chunk_impl._cache_size()
    carry2 = tk.stream_start(tg, kcap=32)
    for lo, hi in ((0, 5), (5, 15), (15, 29)):   # new lengths 5, 10, 14
        carry2, _ = tk.decode_chunk(tg, jnp.asarray(ll[lo:hi]), carry2, kcap=32)
    assert tk._decode_chunk_impl._cache_size() == n0  # no new compiles


@pytest.fixture(scope="module")
def system():
    task = phone_task.PhoneTask(gcorpus.VOCAB[:6], states_per_phone=2)
    train_corpus = gcorpus.make_corpus(30, seed=0)
    feats, transcripts = [], []
    for ws, x in train_corpus:
        ws = [w if w in task.vocab else task.vocab[0] for w in ws]
        f = jft.mfcc(np.asarray(x, np.float32), SR)
        feats.append(np.asarray(jft.cmn(f)))
        transcripts.append(ws)
    params = trainer.train(task, feats, transcripts, num_comp=2, iters=2)
    arpa = lm.train_arpa_bigram(transcripts, task.vocab)
    G = lm.arpa_to_fst(arpa, task.words)
    L, ndis = hclg.build_lexicon_fst(task.lexicon, task.phones, task.words,
                                     sil_phone="sil")
    H = hclg.build_hmm_fst(len(task.phones) - 1, ndis, states_per_phone=task.spp)
    graph = pack(hclg.compose_hclg(H, L, G, len(task.phones) - 1, ndis))
    return task, params, tk.build_token_graph(graph)


def _multichannel(x, geom):
    POS = np.asarray(geom.positions)
    src = np.array([0.4, 1.2, 0.0])
    xm = groom.simulate(np.asarray(x, np.float32), POS, src, SR, snr_db=25.0,
                        rng=np.random.default_rng(7))
    return xm.astype(np.float32), src


def test_streaming_chain_matches_offline(system):
    task, params, tg = system
    geom = ArrayGeometry.linear(4, 0.05)
    pipe = DsrPipeline(
        fb=FilterbankConfig(M=64, m=2, r=2), geometry=geom,
        beamformer=BeamformerConfig(kind="ds"),
    )
    _, x = gcorpus.make_corpus(1, min_words=2, max_words=3, seed=77)[0]
    xm, src_pos = _multichannel(x, geom)

    # ---- offline reference: full-utterance subbands → feats → decode ----
    import dsr.ops.filterbank as jfb

    A = jfb.analysis(jnp.asarray(xm, jnp.float32), pipe.fb)
    Y_off, _ = pipe.beamform_subbands(A, src_pos)
    feats_off = jft.mfcc_from_subbands(Y_off, pipe.fb.M, SR)
    cep_mean = np.asarray(feats_off).mean(axis=0)   # fixed (non-causal CMN
    # is not streamable; production uses a precomputed mean)
    ll_off = jgmm.loglik(params, jnp.asarray(np.asarray(feats_off) - cep_mean))
    olabs_off, score_off = tk.decode(tg, ll_off, kcap=128)
    words_off = [int(w) for w in np.asarray(olabs_off) if w]

    # ---- streamed: ragged chunks through the full chain ------------------
    S = xm.shape[-1]
    cuts = [0, 1500, 5000, 5600, 12000, S]
    chunks = [xm[:, cuts[i]:cuts[i + 1]] for i in range(len(cuts) - 1)]
    rec = StreamingRecognizer(
        pipe, lambda f: jgmm.loglik(params, f), tg, src_pos,
        kcap=128, cep_mean=cep_mean,
    )
    words_s, score_s = rec.run(chunks)
    assert words_s == words_off
    assert score_s == pytest.approx(float(score_off), abs=0.1)


def test_streaming_subbands_match_offline(system):
    geom = ArrayGeometry.linear(4, 0.05)
    pipe = DsrPipeline(
        fb=FilterbankConfig(M=64, m=2, r=2), geometry=geom,
        beamformer=BeamformerConfig(kind="mvdr"),
    )
    _, x = gcorpus.make_corpus(1, min_words=2, max_words=2, seed=78)[0]
    xm, src_pos = _multichannel(x, geom)
    import dsr.ops.filterbank as jfb

    A = jfb.analysis(jnp.asarray(xm, jnp.float32), pipe.fb)
    Y_off, _ = pipe.beamform_subbands(A, src_pos)
    Ys = [np.asarray(Y) for Y in
          pipe.process_streaming_subbands(
              [xm[:, :4000], xm[:, 4000:4096], xm[:, 4096:]], src_pos)]
    Y_cat = np.concatenate(Ys, axis=0)
    assert Y_cat.shape == Y_off.shape
    ref = np.asarray(Y_off)
    assert np.max(np.abs(Y_cat - ref)) / np.max(np.abs(ref)) < 1e-5
