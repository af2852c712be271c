"""Pipeline parallelism gate (SURVEY.md §2.3 PP row): GPipe-style stage
pipeline over a `stage` mesh axis equals the sequential layer composition."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from dsr.parallel.pipeline_parallel import pipeline_apply


def _layer(p, x):
    W, b = p["W"], p["b"]
    return x + jnp.tanh(x @ W + b)          # residual, shape-preserving


@pytest.mark.parametrize("n_stages,n_micro", [(4, 6), (8, 3), (2, 1)])
def test_pipeline_matches_sequential(n_stages, n_micro):
    devs = np.array(jax.devices()[:n_stages])
    mesh = Mesh(devs, ("stage",))
    rng = np.random.default_rng(0)
    D, B, T = 8, 2, 5
    params = {
        "W": jnp.asarray(rng.standard_normal((n_stages, D, D)) * 0.3, jnp.float32),
        "b": jnp.asarray(rng.standard_normal((n_stages, D)) * 0.1, jnp.float32),
    }
    xs = jnp.asarray(rng.standard_normal((n_micro, B, T, D)), jnp.float32)
    with mesh:
        ys = pipeline_apply(mesh, "stage", _layer, params, xs)
    # sequential reference
    ref = xs
    for s in range(n_stages):
        ref = jax.vmap(lambda x: _layer(jax.tree.map(lambda a: a[s], params), x))(ref)
    np.testing.assert_allclose(np.asarray(ys), np.asarray(ref), atol=2e-5)


def test_pipeline_conformer_stack():
    """The config-5 shape: a stack of Conformer blocks pipelined 2-stage."""
    from dsr.models import conformer as cfm

    devs = np.array(jax.devices()[:2])
    mesh = Mesh(devs, ("stage",))
    blk = cfm.ConformerBlock(16, heads=2)
    rng = np.random.default_rng(1)
    x0 = jnp.asarray(rng.standard_normal((2, 12, 16)), jnp.float32)
    p0 = blk.init(jax.random.PRNGKey(0), x0)
    p1 = blk.init(jax.random.PRNGKey(1), x0)
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), p0, p1)
    xs = jnp.asarray(rng.standard_normal((3, 2, 12, 16)), jnp.float32)
    with mesh:
        ys = pipeline_apply(mesh, "stage", lambda p, x: blk.apply(p, x), stacked, xs)
    ref = jax.vmap(lambda x: blk.apply(p1, blk.apply(p0, x)))(xs)
    np.testing.assert_allclose(np.asarray(ys), np.asarray(ref), atol=3e-5)
