"""Sequence-parallel attention for long audio (SURVEY.md §5 long-context).

Two standard schemes over a time-sharded mesh axis, for the Conformer-CTC
acoustic model (config 5) on utterances too long for one chip's memory:

  - `ring_attention`: K/V blocks rotate around the device ring via `ppermute`
    while each device streams flash-style (running max / denominator)
    softmax accumulation over its local Q block — full exact attention,
    O(T/n) activation memory per device, compute overlapped with the ring
    transfers by XLA.
  - `ulysses_attention`: `all_to_all` re-shards time→heads so each device
    holds the FULL sequence for H/n heads, computes plain attention, and
    scatters back.  Fewer collective steps; needs heads % n == 0.

Both support the Conformer's bucketed relative-position bias with GLOBAL
time indices (each shard knows its offset from its axis rank), so results
match single-device `RelPosSelfAttention` exactly — verified in
tests/test_longctx.py on the 8-device CPU mesh.

Reference status: the upstream toolkit processed unbounded streams frame
by frame and had no attention at all [K]; this module is the batched JAX
long-context mechanism mandated by SURVEY.md §5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def relpos_bias_block(bias_table: jnp.ndarray, qpos: jnp.ndarray,
                      kpos: jnp.ndarray, max_dist: int) -> jnp.ndarray:
    """Bucketed relative-position bias for a (q-block, k-block) pair.

    bias_table: (2*max_dist+1, H); qpos: (Tq,), kpos: (Tk,) global frame
    indices → (H, Tq, Tk), matching models/conformer.RelPosSelfAttention.
    """
    rel = jnp.clip(qpos[:, None] - kpos[None, :], -max_dist, max_dist) + max_dist
    return jnp.transpose(bias_table[rel], (2, 0, 1))


def ring_attention(q, k, v, axis_name: str, bias_table=None, max_dist: int = 128,
                   kv_mask=None):
    """Exact attention with time sharded over `axis_name`.

    q, k, v: (..., Tl, H, dh) local shards (global T = n * Tl, contiguous
    blocks in rank order).  bias_table: optional (2*max_dist+1, H) bucketed
    relative-position table.  kv_mask: optional (..., Tl) bool — True =
    valid key frame (rotates with K/V).  Returns (..., Tl, H, dh).
    """
    n = lax.psum(1, axis_name)
    rank = lax.axis_index(axis_name)
    Tl, H, dh = q.shape[-3:]
    scale = 1.0 / np.sqrt(dh)
    qpos = rank * Tl + jnp.arange(Tl)

    # constants are replicated-typed under shard_map; the loop rotates them
    # per rank, so mark the whole carry varying up front (no-op for values
    # that already vary over the axis)
    def vary(x):
        try:
            if axis_name in jax.typeof(x).vma:
                return x
        except AttributeError:
            pass
        return lax.pcast(x, axis_name, to="varying")
    m = vary(jnp.full((*q.shape[:-3], H, Tl), -jnp.inf, q.dtype))  # running max
    l = vary(jnp.zeros((*q.shape[:-3], H, Tl), q.dtype))           # running denom
    acc = vary(jnp.zeros_like(q))
    perm = [(i, (i + 1) % n) for i in range(n)]
    if kv_mask is None:
        kv_mask = jnp.ones((*k.shape[:-3], Tl), bool)
    kv_mask = vary(kv_mask)

    def step(j, carry):
        m, l, acc, k, v, kv_mask = carry
        src = (rank - j) % n                     # rank whose K/V block we hold
        logits = jnp.einsum("...thd,...shd->...hts", q, k) * scale
        if bias_table is not None:
            kpos = src * Tl + jnp.arange(Tl)
            logits = logits + relpos_bias_block(bias_table, qpos, kpos, max_dist)
        logits = jnp.where(kv_mask[..., None, None, :], logits, -jnp.inf)
        m_new = jnp.maximum(m, jnp.max(logits, axis=-1))
        # keep -inf rows (fully masked so far) from producing NaNs
        m_safe = jnp.where(jnp.isinf(m_new), 0.0, m_new)
        p = jnp.exp(logits - m_safe[..., None])
        p = jnp.where(kv_mask[..., None, None, :], p, 0.0)
        corr = jnp.where(jnp.isinf(m), 0.0, jnp.exp(m - m_safe))
        l = l * corr + jnp.sum(p, axis=-1)
        acc = acc * jnp.moveaxis(corr, -2, -1)[..., None] + jnp.einsum(
            "...hts,...shd->...thd", p, v
        )
        m = m_new
        k, v, kv_mask = (
            lax.ppermute(k, axis_name, perm),
            lax.ppermute(v, axis_name, perm),
            lax.ppermute(kv_mask, axis_name, perm),
        )
        return m, l, acc, k, v, kv_mask

    m, l, acc, _, _, _ = lax.fori_loop(0, n, step, (m, l, acc, k, v, kv_mask))
    denom = jnp.moveaxis(l, -2, -1)[..., None]
    return acc / jnp.maximum(denom, 1e-30)


def exchange_halo(x, axis_name: str, halo: int, time_axis: int = -2):
    """Concatenate `halo` boundary frames from each ring neighbour onto a
    time-sharded array: (..., Tl, D) → (..., halo + Tl + halo, D).

    Edge shards receive zeros (ppermute sends nothing to absent targets),
    which equals global zero 'SAME' padding — so a local VALID convolution
    over the haloed block reproduces the unsharded SAME convolution
    exactly (the Conformer conv module's SP path)."""
    n = lax.psum(1, axis_name)
    time_axis = time_axis % x.ndim
    Tl = x.shape[time_axis]

    def tslice(start, size):
        idx = [slice(None)] * x.ndim
        idx[time_axis] = slice(start, start + size)
        return x[tuple(idx)]

    fwd = [(i, i + 1) for i in range(n - 1)]   # rank r receives from r-1
    bwd = [(i + 1, i) for i in range(n - 1)]   # rank r receives from r+1
    left = lax.ppermute(tslice(Tl - halo, halo), axis_name, fwd)
    right = lax.ppermute(tslice(0, halo), axis_name, bwd)
    return jnp.concatenate([left, x, right], axis=time_axis)


def ulysses_attention(q, k, v, axis_name: str, bias_table=None,
                      max_dist: int = 128, kv_mask=None):
    """all_to_all head-scatter attention (DeepSpeed-Ulysses scheme).

    q, k, v: (..., Tl, H, dh) time-sharded → all_to_all to (..., T, H/n, dh)
    head-sharded, plain softmax attention with global relative-position
    bias, all_to_all back.  Requires H % axis size == 0.
    """
    n = lax.psum(1, axis_name)
    Tl, H, dh = q.shape[-3:]

    def scatter(x):  # (..., Tl, H, dh) → (..., n*Tl, H/n, dh)
        return lax.all_to_all(x, axis_name, split_axis=x.ndim - 2,
                              concat_axis=x.ndim - 3, tiled=True)

    def gather(x):   # inverse
        return lax.all_to_all(x, axis_name, split_axis=x.ndim - 3,
                              concat_axis=x.ndim - 2, tiled=True)

    qg, kg, vg = scatter(q), scatter(k), scatter(v)
    T = qg.shape[-3]
    scale = 1.0 / np.sqrt(dh)
    logits = jnp.einsum("...thd,...shd->...hts", qg, kg) * scale
    if bias_table is not None:
        pos = jnp.arange(T)
        # per-device head slice of the bias table
        hs = H // n
        r = lax.axis_index(axis_name)
        table = lax.dynamic_slice_in_dim(bias_table, r * hs, hs, axis=1)
        logits = logits + relpos_bias_block(table, pos, pos, max_dist)
    if kv_mask is not None:
        kmg = lax.all_gather(kv_mask, axis_name, axis=kv_mask.ndim - 1, tiled=True)
        logits = jnp.where(kmg[..., None, None, :], logits, -1e30)
    attn = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("...hts,...shd->...thd", attn, vg)
    return gather(out)
