"""Streaming Conformer-CTC — chunked causal inference with carried state
(round-4 VERDICT item 6; SURVEY.md §5 long-context: the reference's whole
API is unbounded streams, so the CTC-path AM needs a streaming mode to
match the WFST decoder's chunk carry).

Design (every shape is FIXED, so a streaming session compiles
each of step/finish exactly once; all state is dense device arrays):

  - attention is CHUNK-CAUSAL: a query attends to every frame of its own
    `chunk` (non-causal within the chunk — the standard streaming
    recipe) plus `left` whole chunks of left context, served from a
    per-layer cache of the LAYER INPUT (everything outside attention and
    the depthwise conv is frame-local, so k/v for cached frames are
    recomputed bit-identically from the cached inputs);
  - the depthwise conv is CAUSAL (VALID over a (k-1)-frame carried tail
    of its post-GLU input — offline pads the same tail with zeros);
  - the 4x subsampler is VALID (no padding): subsampled frame t needs
    raw frames 4t..4t+6, so `step` n consumes raw chunk n (4·chunk
    frames) and emits attention chunk n-1 — ONE step of latency buys
    fixed shapes and exact chunk alignment; `finish` flushes the final
    chunk-1 frames.

The SAME flax module runs both ways: `apply(p, feats)` is the offline
chunk-causal reference; `apply(p, chunk, state, method="step")` streams.
Parity is exact and gated by tests/test_streaming_conformer.py:
concat(streamed logits) == offline logits to float tolerance.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

NEG = -1e30


class StreamState(NamedTuple):
    """Carried streaming state (fixed-shape device arrays)."""
    raw: jnp.ndarray        # (4*chunk, D) previous raw chunk
    xin: Any                # per-layer (left*chunk, dim) layer-input tail
    conv: Any               # per-layer (k-1, dim) post-GLU conv tail
    pos: jnp.ndarray        # () absolute index of the next emitted frame
    started: jnp.ndarray    # () bool: one raw chunk already buffered


class _FeedForward(nn.Module):
    dim: int
    mult: int = 4

    @nn.compact
    def __call__(self, x):
        h = nn.LayerNorm()(x)
        h = nn.Dense(self.dim * self.mult)(h)
        h = nn.swish(h)
        return nn.Dense(self.dim)(h)


class _ChunkCausalAttention(nn.Module):
    """q from `x`, k/v from `xkv` (one LayerNorm applied to each — the
    cached path feeds xkv = cache ++ x so the normalisation of the x rows
    is identical in both uses), bucketed relative-position bias, and an
    `allow` (Tq, Tk) mask."""

    dim: int
    heads: int
    max_dist: int = 128

    @nn.compact
    def __call__(self, x, xkv, q_pos, kv_pos, allow):
        dh = self.dim // self.heads
        ln = nn.LayerNorm(name="ln")
        h = ln(x)
        hkv = ln(xkv)
        q = nn.DenseGeneral((self.heads, dh), name="q")(h)
        k = nn.DenseGeneral((self.heads, dh), name="k")(hkv)
        v = nn.DenseGeneral((self.heads, dh), name="v")(hkv)
        bias = self.param("rel_bias", nn.initializers.zeros,
                          (2 * self.max_dist + 1, self.heads))
        logits = jnp.einsum("thd,shd->hts", q, k) / np.sqrt(dh)
        rel = jnp.clip(q_pos[:, None] - kv_pos[None, :],
                       -self.max_dist, self.max_dist) + self.max_dist
        logits = logits + jnp.transpose(bias[rel], (2, 0, 1))
        logits = jnp.where(allow[None, :, :], logits, NEG)
        attn = jax.nn.softmax(logits, axis=-1)
        out = jnp.einsum("hts,shd->thd", attn, v)
        return nn.DenseGeneral(self.dim, axis=(-2, -1), name="o")(out)


class StreamingConformerCtc(nn.Module):
    """Chunk-causal Conformer-CTC (single-utterance; batch via vmap).

    chunk/left are in SUBSAMPLED frames (1 subsampled = 4 raw frames).
    Offline: `apply(p, feats (T, D))` → (T', vocab+1), T' = (T-7)//4+1.
    Streaming: `init_state()` → `step(raw (4*chunk, D), state)` per raw
    chunk (the first step returns n=0) → `finish(state)` for the tail.
    """

    vocab: int
    dim: int = 144
    layers: int = 4
    heads: int = 4
    chunk: int = 8
    left: int = 2
    kernel_size: int = 15
    feat_dim: int = 13

    def setup(self):
        d4 = max(self.dim // 4, 1)
        self.sub1 = nn.Conv(d4, (3, 3), strides=(2, 2), padding="VALID")
        self.sub2 = nn.Conv(d4, (3, 3), strides=(2, 2), padding="VALID")
        self.sub_out = nn.Dense(self.dim)
        # frame-local normalisation after the subsampler: real-scale MFCCs
        # (|x| ~ 30) otherwise ride the residual stream unnormalised and
        # the CTC backward explodes at init (measured inf grad norms)
        self.sub_ln = nn.LayerNorm()
        self.ff1s = [_FeedForward(self.dim) for _ in range(self.layers)]
        self.atts = [_ChunkCausalAttention(self.dim, self.heads)
                     for _ in range(self.layers)]
        self.conv_lns = [nn.LayerNorm() for _ in range(self.layers)]
        self.conv_ins = [nn.Dense(2 * self.dim) for _ in range(self.layers)]
        self.conv_dws = [
            nn.Conv(self.dim, (self.kernel_size,),
                    feature_group_count=self.dim, padding="VALID")
            for _ in range(self.layers)]
        self.conv_post_lns = [nn.LayerNorm() for _ in range(self.layers)]
        self.conv_outs = [nn.Dense(self.dim) for _ in range(self.layers)]
        self.ff2s = [_FeedForward(self.dim) for _ in range(self.layers)]
        self.block_lns = [nn.LayerNorm() for _ in range(self.layers)]
        self.out = nn.Dense(self.vocab + 1)

    # ---- shared pieces ---------------------------------------------------

    def _subsample(self, raw):
        h = raw[..., None]
        h = nn.relu(self.sub1(h))
        h = nn.relu(self.sub2(h))
        h = h.reshape(h.shape[0], -1)
        return self.sub_ln(self.sub_out(h))

    def _block(self, i, x, kv_tail, conv_tail, q_pos, kv_pos, allow):
        """One block over chunk rows `x`; kv_tail (L, dim) is the cached
        layer input (None offline), conv_tail (k-1, dim) the post-GLU
        history.  Returns (y, this layer's new caches)."""
        x1 = x + 0.5 * self.ff1s[i](x)
        if kv_tail is None:
            xkv = x1
        else:
            # cached rows re-derive x1 from the cached layer input —
            # frame-local, so bit-identical to when they were the chunk
            xkv = jnp.concatenate(
                [kv_tail + 0.5 * self.ff1s[i](kv_tail), x1], axis=0)
        x2 = x1 + self.atts[i](x1, xkv, q_pos, kv_pos, allow)
        h = nn.glu(self.conv_ins[i](self.conv_lns[i](x2)), axis=-1)
        hist = jnp.concatenate([conv_tail, h], axis=0)
        c = self.conv_dws[i](hist)
        c = nn.swish(self.conv_post_lns[i](c))
        x3 = x2 + self.conv_outs[i](c)
        y = self.block_lns[i](x3 + 0.5 * self.ff2s[i](x3))
        k1 = self.kernel_size - 1
        return y, hist[-k1:]

    # ---- offline chunk-causal reference ---------------------------------

    def __call__(self, feats):
        h = self._subsample(feats)
        T = h.shape[0]
        pos = jnp.arange(T)
        cq, cs = pos[:, None] // self.chunk, pos[None, :] // self.chunk
        allow = (cs == cq) | ((cq - cs >= 1) & (cq - cs <= self.left))
        k1 = self.kernel_size - 1
        for i in range(self.layers):
            h, _ = self._block(i, h, None,
                               jnp.zeros((k1, self.dim), h.dtype),
                               pos, pos, allow)
        return self.out(h)

    # ---- streaming -------------------------------------------------------

    def init_state(self, dtype=jnp.float32) -> StreamState:
        L = self.left * self.chunk
        k1 = self.kernel_size - 1
        return StreamState(
            raw=jnp.zeros((4 * self.chunk, self.feat_dim), dtype),
            xin=[jnp.zeros((L, self.dim), dtype)
                 for _ in range(self.layers)],
            conv=[jnp.zeros((k1, self.dim), dtype)
                  for _ in range(self.layers)],
            pos=jnp.zeros((), jnp.int32),
            started=jnp.zeros((), bool))

    def _stream_blocks(self, h, state: StreamState, C):
        """Run the block stack on C chunk rows with the carried caches;
        returns (logits, new_xin, new_conv)."""
        L = self.left * self.chunk
        q_pos = state.pos + jnp.arange(C)
        kv_pos = jnp.concatenate([state.pos - L + jnp.arange(L), q_pos])
        allow = jnp.broadcast_to((kv_pos >= 0)[None, :], (C, L + C))
        new_xin, new_conv = [], []
        for i in range(self.layers):
            xin_cat = jnp.concatenate([state.xin[i], h], axis=0)
            new_xin.append(xin_cat[-L:] if C < L else h[-L:])
            y, ctail = self._block(i, h, state.xin[i], state.conv[i],
                                   q_pos, kv_pos, allow)
            new_conv.append(ctail)
            h = y
        return self.out(h), new_xin, new_conv

    def step(self, raw_chunk, state: StreamState):
        """raw_chunk (4*chunk, D) → (logits (chunk, V+1), n_new, state).
        n_new is 0 on the first call (its chunk is only buffered) and
        `chunk` afterwards; logits rows beyond n_new are garbage."""
        C = self.chunk
        window = jnp.concatenate([state.raw, raw_chunk], axis=0)[:4 * C + 3]
        h = self._subsample(window)                       # (C, dim)
        logits, new_xin, new_conv = self._stream_blocks(h, state, C)
        started = state.started
        keep = lambda new, old: [jnp.where(started, n, o)
                                 for n, o in zip(new, old)]
        n_new = jnp.where(started, C, 0).astype(jnp.int32)
        new_state = StreamState(
            raw=raw_chunk,
            xin=keep(new_xin, state.xin),
            conv=keep(new_conv, state.conv),
            pos=state.pos + n_new,
            started=jnp.ones((), bool))
        return logits, n_new, new_state

    def finish(self, state: StreamState):
        """Flush the final buffered chunk → (logits (chunk-1, V+1), n_new).
        Offline emits (T-7)//4+1 frames for T raw; after n steps of 4C raw
        the tail holds exactly C-1 more subsampled frames."""
        C = self.chunk
        h = self._subsample(state.raw)                    # (C-1, dim)
        logits, _, _ = self._stream_blocks(h, state, C - 1)
        n_new = jnp.where(state.started, C - 1, 0).astype(jnp.int32)
        return logits, n_new


def greedy_ctc_stream(logits_chunks) -> np.ndarray:
    """Incremental best-path decode over emitted chunks: collapse repeats
    and drop blanks across chunk boundaries (prev label carried)."""
    out, prev = [], -1
    for lg in logits_chunks:
        ids = np.asarray(jnp.argmax(lg, axis=-1))
        for i in ids:
            if i != prev and i != 0:
                out.append(int(i))
            prev = int(i)
    return np.asarray(out, np.int32)
