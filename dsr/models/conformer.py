"""Conformer-CTC acoustic model (flax.linen) — BASELINE.json config 5.

Design: all matmuls are batched, in bf16-friendly shapes; attention
uses standard dot-product with relative-position bias; the conv module uses
depthwise 1-D convolution; training loss is `optax.ctc_loss`.  Parameters
shard per `parallel.sharding` (attention/FFN column-row over `model`,
activations over `data`).

Long audio (SURVEY.md §5): every block is sequence-parallel capable — set
`sp_axis` to a time-sharded mesh axis and run the block stack under
`jax.shard_map`; attention becomes exact ring attention (ppermute K/V
rotation, parallel.longctx) and the depthwise conv exchanges halo frames
with ring neighbours.  The subsampling front end is strided and therefore
stays local: shard time AFTER it (wrap the block stack, not ConformerCtc,
in shard_map) — tests/test_longctx.py shows the pattern and verifies
sharded == dense.
"""

from __future__ import annotations

import functools
from typing import Any

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np


class FeedForward(nn.Module):
    dim: int
    mult: int = 4
    dropout: float = 0.0

    @nn.compact
    def __call__(self, x, train=False):
        h = nn.LayerNorm()(x)
        h = nn.Dense(self.dim * self.mult)(h)
        h = nn.swish(h)
        h = nn.Dropout(self.dropout, deterministic=not train)(h)
        h = nn.Dense(self.dim)(h)
        return nn.Dropout(self.dropout, deterministic=not train)(h)


class RelPosSelfAttention(nn.Module):
    dim: int
    heads: int = 4
    max_dist: int = 128
    sp_axis: str | None = None  # time-sharded mesh axis → ring attention

    @nn.compact
    def __call__(self, x, mask=None):
        T = x.shape[-2]
        h = nn.LayerNorm()(x)
        dh = self.dim // self.heads
        q = nn.DenseGeneral((self.heads, dh), name="q")(h)
        k = nn.DenseGeneral((self.heads, dh), name="k")(h)
        v = nn.DenseGeneral((self.heads, dh), name="v")(h)
        bias_table = self.param(
            "rel_bias", nn.initializers.zeros, (2 * self.max_dist + 1, self.heads)
        )
        if self.sp_axis is not None:
            from dsr.parallel import longctx

            out = longctx.ring_attention(
                q, k, v, self.sp_axis, bias_table, self.max_dist, kv_mask=mask
            )
            return nn.DenseGeneral(self.dim, axis=(-2, -1), name="o")(out)
        logits = jnp.einsum("...thd,...shd->...hts", q, k) / np.sqrt(dh)
        # bucketed relative-position bias
        rel = jnp.clip(
            jnp.arange(T)[:, None] - jnp.arange(T)[None, :],
            -self.max_dist, self.max_dist,
        ) + self.max_dist
        logits = logits + jnp.transpose(bias_table[rel], (2, 0, 1))
        if mask is not None:
            logits = jnp.where(mask[..., None, None, :], logits, -1e30)
        attn = jax.nn.softmax(logits, axis=-1)
        out = jnp.einsum("...hts,...shd->...thd", attn, v)
        return nn.DenseGeneral(self.dim, axis=(-2, -1), name="o")(out)


class ConvModule(nn.Module):
    dim: int
    kernel_size: int = 15
    sp_axis: str | None = None  # time-sharded mesh axis → halo exchange

    @nn.compact
    def __call__(self, x):
        h = nn.LayerNorm()(x)
        h = nn.Dense(2 * self.dim)(h)
        h = nn.glu(h, axis=-1)
        if self.sp_axis is not None:
            from dsr.parallel import longctx

            # SAME zero padding globally == halo frames from ring
            # neighbours (edge shards receive zeros) + VALID conv locally
            h = longctx.exchange_halo(h, self.sp_axis, self.kernel_size // 2)
            pad = "VALID"
        else:
            pad = "SAME"
        h = nn.Conv(
            self.dim, (self.kernel_size,), feature_group_count=self.dim, padding=pad
        )(h)
        h = nn.LayerNorm()(h)  # stand-in for batchnorm (streaming-safe)
        h = nn.swish(h)
        return nn.Dense(self.dim)(h)


class ConformerBlock(nn.Module):
    dim: int
    heads: int = 4
    sp_axis: str | None = None  # run under shard_map with time over this axis

    @nn.compact
    def __call__(self, x, mask=None, train=False):
        x = x + 0.5 * FeedForward(self.dim)(x, train)
        x = x + RelPosSelfAttention(self.dim, self.heads, sp_axis=self.sp_axis)(x, mask)
        x = x + ConvModule(self.dim, sp_axis=self.sp_axis)(x)
        x = x + 0.5 * FeedForward(self.dim)(x, train)
        return nn.LayerNorm()(x)


class ConformerCtc(nn.Module):
    """features (…, T, D) → CTC logits (…, T//4, vocab+1) (blank = 0)."""

    vocab: int
    dim: int = 144
    layers: int = 4
    heads: int = 4

    @nn.compact
    def __call__(self, feats, mask=None, train=False):
        # 4x time subsampling via two strided convs
        h = feats[..., None]
        h = nn.Conv(self.dim // 4, (3, 3), strides=(2, 2))(h)
        h = nn.relu(h)
        h = nn.Conv(self.dim // 4, (3, 3), strides=(2, 2))(h)
        h = nn.relu(h)
        h = h.reshape(*h.shape[:-2], -1)
        h = nn.Dense(self.dim)(h)
        sub_mask = None
        if mask is not None:
            sub_mask = mask[..., ::2][..., ::2][..., : h.shape[-2]]
        for _ in range(self.layers):
            h = ConformerBlock(self.dim, self.heads)(h, sub_mask, train)
        return nn.Dense(self.vocab + 1)(h)


def ctc_loss(logits, logit_lens, labels, label_lens):
    """optax CTC wrapper: logits (B, T, V+1) with blank id 0."""
    import optax

    B, T, _ = logits.shape
    logit_pad = (jnp.arange(T)[None, :] >= logit_lens[:, None]).astype(jnp.float32)
    L = labels.shape[1]
    label_pad = (jnp.arange(L)[None, :] >= label_lens[:, None]).astype(jnp.float32)
    per_seq = optax.ctc_loss(logits, logit_pad, labels, label_pad)
    return jnp.mean(per_seq)


def greedy_ctc_decode(logits, length=None) -> np.ndarray:
    """Best-path decode: collapse repeats, drop blanks (id 0)."""
    ids = np.asarray(jnp.argmax(logits, axis=-1))
    out = []
    prev = -1
    for t, i in enumerate(ids):
        if length is not None and t >= length:
            break
        if i != prev and i != 0:
            out.append(int(i))
        prev = i
    return np.asarray(out, np.int32)


NEG = -1e30


@functools.partial(jax.jit, static_argnames=("beam", "max_len"))
def _beam_ctc_impl(logp, length, lm, lm_weight, bonus, *, beam, max_len):
    T, V1 = logp.shape

    def lse(a, b):
        m = jnp.maximum(a, b)
        ms = jnp.where(m > NEG / 2, m, 0.0)
        return jnp.where(m > NEG / 2,
                         ms + jnp.log(jnp.exp(a - ms) + jnp.exp(b - ms)), NEG)

    prefixes0 = jnp.zeros((beam, max_len), jnp.int32)
    lens0 = jnp.zeros((beam,), jnp.int32)
    last0 = jnp.zeros((beam,), jnp.int32)          # 0 = <s>/blank sentinel
    pb0 = jnp.full((beam,), NEG).at[0].set(0.0)
    pnb0 = jnp.full((beam,), NEG)

    def step(carry, inp):
        prefixes, lens, last, pb, pnb = carry
        t, lp = inp
        tot = lse(pb, pnb)                                      # (B,)
        # column 0: stay on the same prefix (blank, or repeat of `last`)
        pb_stay = tot + lp[0]
        pnb_stay = pnb + lp[last]
        stay_tot = lse(pb_stay, pnb_stay)
        # columns 1..V: extend with char c — a repeat of `last` may only
        # cross a blank (pb); anything else extends from the full mass —
        # plus shallow LM fusion lm[last, c] and the insertion bonus
        base = jnp.where(jnp.arange(1, V1)[None, :] == last[:, None],
                         pb[:, None], tot[:, None])             # (B, V)
        # a full prefix cannot extend (silently overwriting the last slot
        # while accumulating score corrupted the hypothesis — review r3)
        base = jnp.where((lens < max_len)[:, None], base, NEG)
        ext = base + lp[1:][None, :] + lm_weight * lm[last, 1:] + bonus
        scores = jnp.concatenate([stay_tot[:, None], ext], axis=1)
        top, idx = jax.lax.top_k(scores.reshape(-1), beam)
        parent = idx // V1
        col = idx % V1
        is_stay = col == 0
        new_prefixes = prefixes[parent]
        new_lens = jnp.where(is_stay, lens[parent], lens[parent] + 1)
        pos = jnp.clip(lens[parent], 0, max_len - 1)
        ext_prefixes = new_prefixes.at[jnp.arange(beam), pos].set(col)
        new_prefixes = jnp.where(is_stay[:, None], new_prefixes, ext_prefixes)
        new_last = jnp.where(is_stay, last[parent], col)
        new_pb = jnp.where(is_stay, pb_stay[parent], NEG)
        new_pnb = jnp.where(is_stay, pnb_stay[parent], top)
        keep = t < length                       # padded frames: no update
        out = tuple(
            jnp.where(keep, n, o)
            for n, o in [(new_prefixes, prefixes), (new_lens, lens),
                         (new_last, last), (new_pb, pb), (new_pnb, pnb)]
        )
        return out, None

    (prefixes, lens, last, pb, pnb), _ = jax.lax.scan(
        step, (prefixes0, lens0, last0, pb0, pnb0),
        (jnp.arange(T), logp))
    total = lse(pb, pnb)
    b = jnp.argmax(total)
    return prefixes[b], lens[b], total[b]


def beam_ctc_decode(logits, beam: int = 8, length=None, lm_logprobs=None,
                    lm_weight: float = 0.3, bonus: float = 0.0,
                    max_len: int = 64):
    """CTC prefix beam search with optional n-gram shallow fusion —
    Batched: one `lax.scan` over frames, every frame scoring all
    B·(V+1) prefix extensions at once (stay = blank/repeat mass merged per
    beam; a repeated label only crosses a blank, the CTC rule greedy
    decoding ignores).  Cross-parent prefix merging is intentionally
    omitted (the fixed-width top-k keeps shapes static; duplicated
    prefixes under-count mass slightly — the standard production
    trade-off).  Prefixes are capped at `max_len` labels: a full beam can
    only continue through blanks/repeats (size max_len generously —
    hypotheses needing more labels are not representable).

    lm_logprobs: (V+1, V+1) table, [prev, c] = log P(c | prev) with row/
    col 0 the sentence-start/blank sentinel, fused as
    `score += lm_weight · lm[last, c] + bonus` per emitted word.
    Returns (ids (np, ≤max_len), total_logprob).  Reference `asr/decoder`
    n-best + LM-rescoring surface [K] in CTC form."""
    logits = jnp.asarray(logits)
    T, V1 = logits.shape
    logp = jax.nn.log_softmax(logits, axis=-1)
    if lm_logprobs is None:
        lm = jnp.zeros((V1, V1), jnp.float32)
    else:
        lm = jnp.asarray(lm_logprobs, jnp.float32)
    ln = jnp.asarray(T if length is None else length, jnp.int32)
    ids, n, score = _beam_ctc_impl(logp, ln, lm, jnp.float32(lm_weight),
                                   jnp.float32(bonus), beam=beam,
                                   max_len=max_len)
    n = int(n)
    return np.asarray(ids)[:n], float(score)
