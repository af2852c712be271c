"""Pipeline parallelism over a `stage` mesh axis (SURVEY.md §2.3 PP row).

The reference has no intra-process parallelism at all; SURVEY ranks PP
"optional: low priority" for DSR because chain stages are cheap relative
to decode — but deep acoustic models (config 5 Conformer stacks) DO
pipeline naturally: layers are sharded over a `stage` axis and microbatches
flow through the classic GPipe schedule, with activations hopping stages
via `ppermute` around the device ring.

Design: everything is ONE SPMD program under `shard_map` — every
stage runs the same `lax.scan` over schedule steps; at step t stage s
processes microbatch t−s (if in range) and permutes its activation to
stage s+1.  No host round-trips, no per-stage programs, fixed shapes.

Constraint: `fn(stage_params, x) -> y` must preserve the activation shape
(true for residual-block stacks — Conformer/Transformer layers).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def pipeline_apply(mesh: Mesh, stage_axis: str, fn, stage_params, xs):
    """Apply the stage composition fn(p[S-1], ... fn(p[1], fn(p[0], x)))
    to each microbatch, pipelined over the `stage_axis` device groups.

    stage_params: pytree whose leaves have leading dim = n_stages (sharded
    over `stage_axis`).  xs: (n_micro, ...) microbatches (replicated).
    Returns (n_micro, ...) outputs, replicated — equal to the sequential
    composition (tested in tests/test_pipeline_parallel.py).
    """
    n_stages = mesh.shape[stage_axis]
    n_micro = xs.shape[0]

    def run_shard(params, xs):
        # params leaves: (1, ...) local stage slice
        params_local = jax.tree.map(lambda a: a[0], params)
        s = jax.lax.axis_index(stage_axis)
        fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]

        def step(carry, t):
            recv = carry                      # activation from stage s-1
            mb = t - s                        # my microbatch index this step
            x_in = jnp.where(s == 0, xs[jnp.clip(t, 0, n_micro - 1)], recv)
            act = fn(params_local, x_in)
            active = (mb >= 0) & (mb < n_micro)
            act = jnp.where(active, act, recv)
            # hop to the next stage (ring hop; the wrap-around link is
            # ignored by the schedule masking)
            sent = jax.lax.ppermute(act, stage_axis, fwd)
            out = jnp.where((s == n_stages - 1) & active, act, 0.0)
            return sent, (out, mb)

        steps = jnp.arange(n_micro + n_stages - 1)
        # the carry is per-stage (varying); mark the zero init accordingly
        carry0 = jax.lax.pcast(jnp.zeros_like(xs[0]), stage_axis, to="varying")
        _, (outs, mbs) = jax.lax.scan(step, carry0, steps)
        # scatter outputs back to microbatch order: the last stage emitted
        # microbatch mb at step mb + (n_stages-1); everyone else emitted 0.
        ys = jnp.zeros_like(xs)
        idx = jnp.clip(mbs, 0, n_micro - 1)
        ys = ys.at[idx].add(outs)
        # only the last stage holds real outputs → sum over stages
        return jax.lax.psum(ys, stage_axis)

    fn_sharded = shard_map(
        run_shard, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(stage_axis), stage_params), P()),
        out_specs=P(),
    )
    return fn_sharded(stage_params, xs)
