"""ML (Baum-Welch / Viterbi) training for GMM-HMM models.

Numerics match `golden/gmm_hmm.py` accumulate/mstep (reference `asr/train/`
E-step accumulators + M-step re-estimation [K]).  Design: the E-step is
einsums over (T, S, C) posteriors — GEMM work — and the cross-utterance /
cross-host reduction that the reference did by summing accumulator FILES
from grid jobs (SURVEY.md §3.4) is a `psum` over the `data` mesh axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from dsr.asr.am.gmm import GmmParams, component_posteriors


class GmmAccum(NamedTuple):
    occ: jnp.ndarray  # (S, C)
    sx: jnp.ndarray   # (S, C, D)
    sxx: jnp.ndarray  # (S, C, D)


def zero_accum(S: int, C: int, D: int) -> GmmAccum:
    return GmmAccum(
        jnp.zeros((S, C), jnp.float32),
        jnp.zeros((S, C, D), jnp.float32),
        jnp.zeros((S, C, D), jnp.float32),
    )


@jax.jit
def accumulate(p: GmmParams, feats: jnp.ndarray, gamma: jnp.ndarray, acc: GmmAccum) -> GmmAccum:
    """E-step for one (batch of) utterance(s).

    feats: (..., T, D); gamma: (..., T, S) state occupancies.  Leading axes
    are summed into the accumulator (utterance batch = data parallelism).
    """
    _, post = component_posteriors(p, feats)            # (..., T, S, C)
    w = post * gamma[..., :, :, None]                   # (..., T, S, C)
    sum_axes = tuple(range(w.ndim - 2))                 # all but (S, C)... includes T
    occ = jnp.sum(w, axis=sum_axes)
    sx = jnp.einsum("...tsc,...td->scd", w, feats)
    sxx = jnp.einsum("...tsc,...td->scd", w, feats**2)
    return GmmAccum(acc.occ + occ, acc.sx + sx, acc.sxx + sxx)


def psum_accum(acc: GmmAccum, axis_name: str) -> GmmAccum:
    """Cross-device reduction (inside pmap/shard_map over the data axis)."""
    return jax.tree.map(lambda a: jax.lax.psum(a, axis_name), acc)


@jax.jit
def mstep(acc: GmmAccum, var_floor: float = 1e-3, min_occ: float = 1e-2) -> GmmParams:
    occ = jnp.maximum(acc.occ, min_occ)[..., None]
    means = acc.sx / occ
    variances = jnp.maximum(acc.sxx / occ - means**2, var_floor)
    w = jnp.maximum(acc.occ, 1e-8)
    logw = jnp.log(w / jnp.sum(w, axis=-1, keepdims=True))
    return GmmParams(means, variances, logw)
