"""Sequence-parallel (ring / Ulysses) attention vs single-device reference
on the 8-device CPU mesh — exact parity including the Conformer's bucketed
relative-position bias and ragged-length key masking (SURVEY.md §5)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from dsr.parallel import longctx

MAXD = 16


def _ref_attention(q, k, v, bias_table, kv_mask=None):
    """Plain full attention, the single-device oracle (matches
    models/conformer.RelPosSelfAttention's inner computation)."""
    dh = q.shape[-1]
    T = q.shape[-3]
    logits = jnp.einsum("...thd,...shd->...hts", q, k) / np.sqrt(dh)
    logits = logits + longctx.relpos_bias_block(
        jnp.asarray(bias_table), jnp.arange(T), jnp.arange(T), MAXD
    )
    if kv_mask is not None:
        logits = jnp.where(kv_mask[..., None, None, :], logits, -1e30)
    attn = jax.nn.softmax(logits, axis=-1)
    return jnp.einsum("...hts,...shd->...thd", attn, v)


def _mk(B, T, H, dh, seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, dh)).astype(np.float32) for _ in range(3))
    bias = (0.1 * rng.standard_normal((2 * MAXD + 1, H))).astype(np.float32)
    mask = None
    if ragged:
        lens = rng.integers(T // 2, T + 1, size=B)
        mask = (np.arange(T)[None, :] < lens[:, None])
    return q, k, v, bias, mask


def _run_sharded(fn, n, q, k, v, mask):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    specs = P(None, "sp")
    args = (q, k, v) if mask is None else (q, k, v, mask)
    in_specs = (P(None, "sp"), P(None, "sp"), P(None, "sp")) + (
        () if mask is None else (P(None, "sp"),)
    )
    shmap = jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=specs, check_vma=False,
    )
    return np.asarray(jax.jit(shmap)(*args))


def test_ring_attention_matches_full():
    B, T, H, dh, n = 2, 64, 3, 8, 8  # heads NOT divisible by n — ring is fine
    q, k, v, bias, _ = _mk(B, T, H, dh, seed=1)
    ref = np.asarray(_ref_attention(*map(jnp.asarray, (q, k, v)), bias))
    out = _run_sharded(
        lambda q, k, v: longctx.ring_attention(q, k, v, "sp", jnp.asarray(bias), MAXD),
        n, q, k, v, None,
    )
    assert np.max(np.abs(out - ref)) < 1e-5


def test_ring_attention_ragged_mask():
    B, T, H, dh, n = 3, 48, 2, 4, 4
    q, k, v, bias, mask = _mk(B, T, H, dh, seed=2, ragged=True)
    ref = np.asarray(_ref_attention(*map(jnp.asarray, (q, k, v)), bias, jnp.asarray(mask)))
    out = _run_sharded(
        lambda q, k, v, m: longctx.ring_attention(
            q, k, v, "sp", jnp.asarray(bias), MAXD, kv_mask=m),
        n, q, k, v, mask,
    )
    # compare only valid query frames (masked queries attend to nothing)
    valid = mask[:, :, None, None]
    assert np.max(np.abs((out - ref) * valid)) < 1e-5


def test_ulysses_attention_matches_full():
    B, T, H, dh, n = 2, 64, 8, 4, 4  # H % n == 0 required
    q, k, v, bias, _ = _mk(B, T, H, dh, seed=3)
    ref = np.asarray(_ref_attention(*map(jnp.asarray, (q, k, v)), bias))
    out = _run_sharded(
        lambda q, k, v: longctx.ulysses_attention(q, k, v, "sp", jnp.asarray(bias), MAXD),
        n, q, k, v, None,
    )
    assert np.max(np.abs(out - ref)) < 1e-5


def test_ulysses_attention_ragged_mask():
    B, T, H, dh, n = 2, 32, 4, 4, 4
    q, k, v, bias, mask = _mk(B, T, H, dh, seed=4, ragged=True)
    ref = np.asarray(_ref_attention(*map(jnp.asarray, (q, k, v)), bias, jnp.asarray(mask)))
    out = _run_sharded(
        lambda q, k, v, m: longctx.ulysses_attention(
            q, k, v, "sp", jnp.asarray(bias), MAXD, kv_mask=m),
        n, q, k, v, mask,
    )
    valid = mask[:, :, None, None]
    assert np.max(np.abs((out - ref) * valid)) < 1e-5


def test_ring_matches_conformer_module_attention():
    """End-to-end: the flax RelPosSelfAttention output is reproduced by
    running its projections + ring attention over a time-sharded mesh."""
    import flax.linen as nn
    from dsr.models.conformer import RelPosSelfAttention

    B, T, D, H = 2, 64, 16, 4
    mod = RelPosSelfAttention(D, heads=H, max_dist=MAXD)
    x = np.random.default_rng(5).standard_normal((B, T, D)).astype(np.float32)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(mod.apply(params, jnp.asarray(x)))

    p = params["params"]
    h = nn.LayerNorm().apply({"params": p["LayerNorm_0"]}, jnp.asarray(x))
    dh = D // H

    def proj(name, y):
        kern = p[name]["kernel"]
        return jnp.einsum("btd,dhc->bthc", y, kern) + p[name]["bias"]

    q, k, v = proj("q", h), proj("k", h), proj("v", h)
    out = _run_sharded(
        lambda q, k, v: longctx.ring_attention(
            q, k, v, "sp", p["rel_bias"], MAXD),
        8, np.asarray(q), np.asarray(k), np.asarray(v), None,
    )
    o = jnp.einsum("bthc,hcd->btd", jnp.asarray(out), p["o"]["kernel"]) + p["o"]["bias"]
    assert np.max(np.abs(np.asarray(o) - ref)) < 1e-4


def test_conformer_block_sequence_parallel_matches_dense():
    """A full ConformerBlock (attention + depthwise conv + FFNs) run
    time-sharded over 8 devices equals the dense single-device block —
    ring attention with global rel-pos bias plus conv halo exchange."""
    from dsr.models.conformer import ConformerBlock

    B, T, D, H, n = 2, 64, 16, 4, 8
    x = np.random.default_rng(6).standard_normal((B, T, D)).astype(np.float32)
    dense = ConformerBlock(D, heads=H)
    params = dense.init(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = np.asarray(dense.apply(params, jnp.asarray(x)))

    sp = ConformerBlock(D, heads=H, sp_axis="sp")
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    from jax.experimental.shard_map import shard_map

    fn = shard_map(
        lambda x: sp.apply(params, x),
        mesh=mesh, in_specs=P(None, "sp"), out_specs=P(None, "sp"),
        check_rep=False,
    )
    out = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    assert np.max(np.abs(out - ref)) < 2e-4


def test_exchange_halo_edges_zero():
    from dsr.parallel.longctx import exchange_halo
    from jax.experimental.shard_map import shard_map

    n, Tl, halo = 4, 8, 3
    x = np.arange(n * Tl, dtype=np.float32).reshape(1, n * Tl, 1)
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    fn = shard_map(
        lambda x: exchange_halo(x, "sp", halo),
        mesh=mesh, in_specs=P(None, "sp"), out_specs=P(None, "sp"),
        check_rep=False,
    )
    out = np.asarray(jax.jit(fn)(jnp.asarray(x)))[0, :, 0]
    blocks = out.reshape(n, Tl + 2 * halo)
    for r in range(n):
        mid = blocks[r, halo:-halo]
        np.testing.assert_array_equal(mid, np.arange(r * Tl, (r + 1) * Tl))
        if r == 0:
            np.testing.assert_array_equal(blocks[r, :halo], 0.0)
        else:
            np.testing.assert_array_equal(
                blocks[r, :halo], np.arange(r * Tl - halo, r * Tl))
        if r == n - 1:
            np.testing.assert_array_equal(blocks[r, -halo:], 0.0)
        else:
            np.testing.assert_array_equal(
                blocks[r, -halo:], np.arange((r + 1) * Tl, (r + 1) * Tl + halo))
