"""Compose-stages public API: the DSR chain as one configurable pipeline.

The reference's user-facing idiom is "build a pipeline by chaining stages
in Python" (SURVEY.md §1/L8, §5 config row) — kept here, but each stage is
a pure batched JAX function and the whole chain runs under one jit.
Streaming uses chunked calls with carried state (filterbank history is
handled by overlap in the chunker; GSC weights and CMN statistics are
explicit state, SURVEY.md §5 long-context).

Example (config 1/2):

    pipe = DsrPipeline(fb=FilterbankConfig(M=256, m=4, r=2),
                       geometry=ArrayGeometry.circular(8, 0.10),
                       beamformer=BeamformerConfig(kind="mvdr"))
    y, feats = pipe.process(x_multi, source_pos=np.array([0., 2., 0.]))
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from dsr.config import ArrayGeometry, BeamformerConfig, FilterbankConfig, FrontendConfig
from dsr.ops import beamforming as jbf
from dsr.ops import dereverb as jder
from dsr.ops import features as jft
from dsr.ops import filterbank as jfb
from dsr.ops import postfilter as jpf
from golden import room as groom


@dataclass
class DsrPipeline:
    fb: FilterbankConfig = field(default_factory=FilterbankConfig)
    geometry: ArrayGeometry = field(default_factory=lambda: ArrayGeometry.linear(8, 0.04))
    beamformer: BeamformerConfig = field(default_factory=BeamformerConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    postfilter: str | None = None   # None | 'zelinski' | 'mccowan'
    dereverb: bool = False

    def steering_delays(self, source_pos: np.ndarray) -> np.ndarray:
        POS = np.asarray(self.geometry.positions)
        return (
            groom.steering_delays(POS, np.asarray(source_pos), self.geometry.sound_speed,
                                  self.frontend.sample_rate)
            / self.frontend.sample_rate
        ).astype(np.float32)

    def beamform_subbands(self, A: jnp.ndarray, source_pos: np.ndarray,
                          gsc_state: jnp.ndarray | None = None):
        """A: (N, T, K) analysis output → (Y (T, K), new_gsc_state|None)."""
        sr = float(self.frontend.sample_rate)
        taus = self.steering_delays(source_pos)
        v = jbf.steering_vectors(jnp.asarray(taus), self.fb.M, sr)
        kind = self.beamformer.kind
        state = None
        if kind == "ds":
            Y = jbf.apply_weights(A, jbf.ds_weights(v))
        elif kind == "mvdr":
            Gamma = jbf.diffuse_coherence(
                np.asarray(self.geometry.positions), self.fb.M, sr, self.geometry.sound_speed
            )
            w = jbf.mvdr_weights(v, Gamma, self.beamformer.diagonal_loading)
            Y = jbf.apply_weights(A, w)
        elif kind == "gsc":
            wq = jbf.ds_weights(v)
            B = jbf.blocking_matrix(v)
            Y, state = jbf.gsc_nlms_block(
                A, wq, B, mu=self.beamformer.mu, eps=self.beamformer.eps,
                wa_norm_cap=self.beamformer.wa_norm_cap, wa0=gsc_state,
            )
        else:
            raise ValueError(f"unknown beamformer kind {kind!r}")
        if self.postfilter == "zelinski":
            Y = jpf.apply_postfilter(Y, jpf.zelinski_weights(A))
        elif self.postfilter == "mccowan":
            Gamma = jbf.diffuse_coherence(
                np.asarray(self.geometry.positions), self.fb.M, sr, self.geometry.sound_speed
            )
            Y = jpf.apply_postfilter(Y, jpf.mccowan_weights(A, Gamma))
        return Y, state

    def process(self, x_multi: np.ndarray, source_pos: np.ndarray):
        """(N, S) waveforms → (enhanced waveform (S,), features (T', D))."""
        x = jnp.asarray(x_multi, jnp.float32)
        A = jfb.analysis(x, self.fb)
        if self.dereverb:
            A = jder.wpe(A)
        Y, _ = self.beamform_subbands(A, source_pos)
        y = jfb.synthesis(Y, self.fb, x.shape[-1])
        feats = jft.mfcc_from_subbands(
            Y, self.fb.M, self.frontend.sample_rate,
            num_mel=self.frontend.num_mel, num_cepstra=self.frontend.num_cepstra,
            fmin=self.frontend.fmin, fmax=self.frontend.fmax,
            vtln_warp=self.frontend.vtln_warp,
        )
        if self.frontend.cmn:
            feats = jft.cmn(feats)
        return y, feats

    def process_streaming(self, chunks, source_pos: np.ndarray):
        """Iterate (N, block) chunks → yields enhanced (block,) chunks.

        Chunked-scan streaming: each chunk is analysed with L samples of
        carried history so boundary-straddling frames are recomputed.  For
        fixed beamformers (ds/mvdr) the concatenated output matches offline
        processing to filterbank precision; for GSC the re-processed overlap
        frames re-adapt (a small, standard streaming approximation).
        """
        gsc_state = None
        L = self.fb.L
        buf = None          # trailing input kept for context: last 2L samples
        emitted = 0         # samples emitted, in global coordinates
        consumed = 0        # input samples consumed, global
        for chunk in chunks:
            chunk = np.asarray(chunk, np.float32)
            buf = chunk if buf is None else np.concatenate([buf, chunk], axis=-1)
            consumed += chunk.shape[-1]
            buf_start = consumed - buf.shape[-1]
            A = jfb.analysis(jnp.asarray(buf), self.fb)
            Y, gsc_state = self.beamform_subbands(A, source_pos, gsc_state)
            y = np.asarray(jfb.synthesis(Y, self.fb, buf.shape[-1]))
            mature_end = consumed - L  # needs ≥ L future samples to be final
            if mature_end > emitted:
                yield y[emitted - buf_start : mature_end - buf_start]
                emitted = mature_end
            keep = min(2 * L, buf.shape[-1])
            buf = buf[..., -keep:]
        if buf is not None and consumed > emitted:  # flush the tail
            buf_start = consumed - buf.shape[-1]
            A = jfb.analysis(jnp.asarray(buf), self.fb)
            Y, gsc_state = self.beamform_subbands(A, source_pos, gsc_state)
            y = np.asarray(jfb.synthesis(Y, self.fb, buf.shape[-1]))
            yield y[emitted - buf_start :]

    def process_streaming_subbands(self, chunks, source_pos: np.ndarray):
        """Iterate (N, block) chunks → yields MATURE beamformed subband
        frames (Tc, K) complex, frame-exact vs offline `process`.

        Frame g of the offline analysis covers x[g·D−P, g·D−P+L); it is
        emitted once its window lies fully inside consumed input.  The
        carried buffer keeps ≥ 2L samples trimmed to a D-aligned global
        offset, so re-analysed boundary frames see exactly the offline
        window (the chunk-local zero pad only ever touches frames already
        emitted).  Fixed beamformers (ds/mvdr) are frame-local → streamed
        output == offline frames; GSC re-adapts over the overlap (same
        approximation as `process_streaming`).
        """
        D, L = self.fb.D, self.fb.L
        mr = L // D
        gsc_state = None
        buf = None
        consumed = 0
        emitted_f = 0           # global frames emitted
        last = False
        chunks = iter(chunks)
        pending = next(chunks, None)
        while pending is not None:
            chunk = np.asarray(pending, np.float32)
            pending = next(chunks, None)
            last = pending is None
            buf = chunk if buf is None else np.concatenate([buf, chunk], axis=-1)
            consumed += chunk.shape[-1]
            buf_start = consumed - buf.shape[-1]
            A = jfb.analysis(jnp.asarray(buf), self.fb)
            Y, gsc_state = self.beamform_subbands(A, source_pos, gsc_state)
            T_local = A.shape[-2]
            if last:
                mf = buf_start // D + T_local      # flush: all local frames
            else:
                mf = consumed // D                 # fully-windowed frames only
            lo = emitted_f - buf_start // D
            hi = mf - buf_start // D
            if hi > lo:
                yield Y[..., lo:hi, :]
                emitted_f = mf
            keep = min(buf.shape[-1], 2 * L + (consumed % D))
            buf = buf[..., -keep:]


class StreamingRecognizer:
    """End-to-end streaming recognition: multi-channel audio chunks in,
    words out, equal to the full-utterance decode (SURVEY.md §5
    long-context; VERDICT round-1 item 7).

    The carried state is exactly (a) the frontend's sample buffer,
    (b) the beamformer's adaptive weights (if any), and (c) the decoder's
    (states, scores) token carry — everything else is frame-local.  Token
    arrays accumulate per chunk; `finish()` runs the utterance-final
    traceback (the reference decoders' behaviour).

    `loglik_fn`: features (T, D) → (T, P) acoustic log-likelihoods (e.g.
    `functools.partial(gmm.loglik, params)`).  `cep_mean`: fixed cepstral
    mean to subtract (utterance-level CMN is not causal; production
    streaming uses a precomputed/global mean).
    """

    def __init__(self, pipe: DsrPipeline, loglik_fn, token_graph,
                 source_pos: np.ndarray, kcap: int = 256, beam: float = 1e9,
                 cep_mean: np.ndarray | None = None):
        from dsr.asr.decoder import topk_decoder as _tk

        self._tk = _tk
        self.pipe = pipe
        self.loglik_fn = loglik_fn
        self.graph = token_graph
        self.source_pos = np.asarray(source_pos)
        self.kcap = min(kcap, token_graph.num_states)
        self.beam = beam
        self.cep_mean = None if cep_mean is None else jnp.asarray(cep_mean)
        self.carry = _tk.stream_start(token_graph, self.kcap)
        self._toks: list[tuple[np.ndarray, np.ndarray]] = []

    def _feats(self, Y):
        fe = self.pipe.frontend
        f = jft.mfcc_from_subbands(
            Y, self.pipe.fb.M, fe.sample_rate, num_mel=fe.num_mel,
            num_cepstra=fe.num_cepstra, fmin=fe.fmin, fmax=fe.fmax,
            vtln_warp=fe.vtln_warp,
        )
        if self.cep_mean is not None:
            f = f - self.cep_mean
        return f

    def run(self, chunks):
        """Consume an iterable of (N, block) chunks; returns
        (words (list of olabel ids), score) — identical to decoding the
        concatenated utterance offline (with the same fixed cep_mean)."""
        for Y in self.pipe.process_streaming_subbands(chunks, self.source_pos):
            ll = self.loglik_fn(self._feats(Y))
            self.carry, toks = self._tk.decode_chunk(
                self.graph, ll, self.carry, self.kcap, self.beam
            )
            self._toks.append((np.asarray(toks[0]), np.asarray(toks[1])))
        return self.finish()

    def finish(self):
        if not self._toks:
            return [], float("-inf")   # no audio consumed
        tok_states = np.concatenate([t for t, _ in self._toks], axis=0)
        tok_arcs = np.concatenate([a for _, a in self._toks], axis=0)
        olabs, score = self._tk.traceback(
            self.graph, jnp.asarray(tok_states), jnp.asarray(tok_arcs), self.carry
        )
        words = [int(w) for w in np.asarray(olabs) if w]
        return words, float(score)


class StreamingCtcRecognizer:
    """CTC-path streaming recognition (SURVEY.md §5; round-4 VERDICT item
    6): multi-channel audio chunks → beamformed subbands → features →
    chunk-causal StreamingConformerCtc steps → INCREMENTAL greedy words.

    The carried state is the frontend's sample buffer + the conformer's
    StreamState (raw tail, per-layer KV/conv tails) + the greedy
    decoder's last-label; features buffer internally until a full
    4·chunk-frame model step is available.  Emitted logits are exactly
    the offline chunk-causal pass's rows, so the incremental transcript
    equals `greedy_ctc_decode(model.apply(params, all_feats))` up to the
    last flushed frame (tests/test_streaming_conformer.py gates this).

    `finish()` flushes the model's one-chunk latency; feature frames
    beyond the last complete model chunk (< 4·chunk of them) are
    discarded, matching the offline pass's valid-frame count on
    chunk-aligned input.
    """

    def __init__(self, pipe: DsrPipeline, model, params,
                 source_pos: np.ndarray, cep_mean: np.ndarray | None = None,
                 cep_scale: np.ndarray | None = None):
        import jax

        self.pipe = pipe
        self.model = model
        self.params = params
        self.source_pos = np.asarray(source_pos)
        self.cep_mean = None if cep_mean is None else np.asarray(cep_mean)
        self.cep_scale = None if cep_scale is None else np.asarray(cep_scale)
        self.state = model.init_state()
        self._fbuf = np.zeros((0, model.feat_dim), np.float32)
        self._step = jax.jit(
            lambda p, c, s: model.apply(p, c, s, method="step"))
        self._prev_label = -1
        self.words: list[int] = []

    def _feats(self, Y):
        fe = self.pipe.frontend
        f = jft.mfcc_from_subbands(
            Y, self.pipe.fb.M, fe.sample_rate, num_mel=fe.num_mel,
            num_cepstra=fe.num_cepstra, fmin=fe.fmin, fmax=fe.fmax,
            vtln_warp=fe.vtln_warp,
        )
        f = np.asarray(f)
        if self.cep_mean is not None:
            f = f - self.cep_mean
        if self.cep_scale is not None:
            f = f / self.cep_scale
        return f.astype(np.float32)

    def _emit(self, logits, n_new):
        ids = np.asarray(jnp.argmax(logits[:int(n_new)], axis=-1))
        out = []
        for i in ids:
            if i != self._prev_label and i != 0:
                out.append(int(i))
            self._prev_label = int(i)
        self.words.extend(out)
        return out

    def run(self, chunks):
        """Consume an iterable of (N, block) audio chunks; yields the
        incrementally emitted label ids per model step."""
        C4 = 4 * self.model.chunk
        for Y in self.pipe.process_streaming_subbands(chunks, self.source_pos):
            self._fbuf = np.concatenate([self._fbuf, self._feats(Y)], axis=0)
            while self._fbuf.shape[0] >= C4:
                raw, self._fbuf = self._fbuf[:C4], self._fbuf[C4:]
                logits, n_new, self.state = self._step(
                    self.params, jnp.asarray(raw), self.state)
                out = self._emit(logits, n_new)
                if out:
                    yield out

    def finish(self):
        """Flush the model's buffered chunk; returns the full label list."""
        logits, n_new = self.model.apply(self.params, self.state,
                                         method="finish")
        self._emit(logits, n_new)
        return self.words
