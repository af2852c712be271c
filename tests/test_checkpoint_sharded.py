"""Sharded checkpoint/resume gates (SURVEY.md §5): per-shard save/restore
without host gathering, complex (adaptive-beamformer) state, and
bit-identical mid-stream training resume on the 8-device mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dsr.utils import checkpoint as ckpt


@pytest.fixture(scope="module")
def mesh():
    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    return Mesh(devs, ("data", "model"))


def test_sharded_roundtrip_values_and_shardings(tmp_path, mesh):
    x = jax.device_put(
        jnp.arange(64.0).reshape(8, 8), NamedSharding(mesh, P("data", "model"))
    )
    y = jax.device_put(jnp.arange(16.0), NamedSharding(mesh, P("model")))
    r = jax.device_put(jnp.float32(3.5), NamedSharding(mesh, P()))
    tree = {"x": x, "nested": {"y": y, "r": r}}
    ckpt.save_sharded(str(tmp_path / "c"), tree)
    out = ckpt.restore_sharded(str(tmp_path / "c"), tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(out)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert a.sharding == b.sharding
        # per-device shard contents identical (no resharding happened)
        for sa, sb in zip(a.addressable_shards, b.addressable_shards):
            assert sa.device == sb.device
            np.testing.assert_array_equal(np.asarray(sa.data), np.asarray(sb.data))


def test_sharded_roundtrip_complex_beamformer_state(tmp_path, mesh):
    """GSC adaptive weights are complex64 — saved and restored as such."""
    K, N = 16, 4
    wa_r = np.random.default_rng(0).standard_normal((K, N - 1)).astype(np.float32)
    wa_i = np.random.default_rng(1).standard_normal((K, N - 1)).astype(np.float32)
    sh = NamedSharding(mesh, P("data"))
    wa = jax.jit(jax.lax.complex, out_shardings=sh)(
        jax.device_put(wa_r, sh), jax.device_put(wa_i, sh)
    )
    ckpt.save_sharded(str(tmp_path / "c"), {"wa": wa})
    out = ckpt.restore_sharded(str(tmp_path / "c"), {"wa": wa})
    np.testing.assert_array_equal(np.asarray(jnp.real(out["wa"])), wa_r)
    np.testing.assert_array_equal(np.asarray(jnp.imag(out["wa"])), wa_i)
    assert out["wa"].dtype == jnp.complex64
    assert out["wa"].sharding == sh


def test_restore_rejects_mismatched_layout(tmp_path, mesh):
    x = jax.device_put(
        jnp.arange(64.0).reshape(8, 8), NamedSharding(mesh, P("data", "model"))
    )
    ckpt.save_sharded(str(tmp_path / "c"), {"x": x})
    x2 = jax.device_put(
        jnp.arange(64.0).reshape(8, 8), NamedSharding(mesh, P("model", "data"))
    )
    with pytest.raises(ValueError, match="bounds"):
        ckpt.restore_sharded(str(tmp_path / "c"), {"x": x2})


def test_midstream_training_resume_bit_identical(tmp_path, mesh):
    """Interrupt-after-iteration-1 + restore == uninterrupted 2 iterations,
    bit for bit (params AND accumulators sharded over the mesh)."""
    from dsr.asr.am import gmm as jgmm
    from dsr.asr.train import ml

    S, C, D, U, T = 8, 2, 6, 8, 20
    rng = np.random.default_rng(0)
    params = jgmm.GmmParams(
        jnp.asarray(rng.standard_normal((S, C, D)), jnp.float32),
        jnp.asarray(0.5 + rng.random((S, C, D)), jnp.float32),
        jnp.asarray(np.log(np.full((S, C), 1.0 / C)), jnp.float32),
    )
    model_sh = NamedSharding(mesh, P("model"))
    data_sh = NamedSharding(mesh, P("data"))
    params = jax.tree.map(lambda a: jax.device_put(a, model_sh), params)
    feats = jax.device_put(
        rng.standard_normal((U, T, D)).astype(np.float32), data_sh
    )

    @jax.jit
    def train_iter(params, feats):
        ll = jgmm.loglik(params, feats)                     # (U, T, S)
        gamma = jax.nn.softmax(ll, axis=-1)
        acc = ml.zero_accum(S, C, D)
        acc = ml.accumulate(params, feats, gamma, acc)
        new = ml.mstep(acc)
        new = jax.lax.with_sharding_constraint(new, model_sh)
        return new, acc

    # uninterrupted: 2 iterations
    p1, acc1 = train_iter(params, feats)
    p2, acc2 = train_iter(p1, feats)

    # interrupted: checkpoint after iter 1 (params + accumulators), restore,
    # continue
    ckpt.save_sharded(str(tmp_path / "mid"), {"params": p1, "acc": acc1})
    rest = ckpt.restore_sharded(str(tmp_path / "mid"), {"params": p1, "acc": acc1})
    p2b, _ = train_iter(rest["params"], feats)

    for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(p2b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert a.sharding == b.sharding


def test_save_restore_wrappers_prefer_available_backend(tmp_path, mesh):
    x = jax.device_put(jnp.arange(8.0), NamedSharding(mesh, P("data")))
    ckpt.save(str(tmp_path / "w"), {"x": x})
    out = ckpt.restore(str(tmp_path / "w"), {"x": x})
    np.testing.assert_array_equal(np.asarray(out["x"]), np.asarray(x))
