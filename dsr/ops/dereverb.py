"""WPE multi-channel dereverberation.

Numerics match `golden/dereverb.py` (btk20-lineage dereverberation [K]).
Design: all K subbands solve their (N·taps × N·taps) weighted normal
equations as ONE batched `jnp.linalg.solve`; the delayed-frame stacking is
static rolls; the variance/filter alternation is a static `iters` loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("taps", "delay", "iters"))
def wpe(Y, taps: int = 8, delay: int = 2, iters: int = 3, eps: float = 1e-10):
    """Y: (N, T, K) complex64 → dereverbed (N, T, K)."""
    N, T, K = Y.shape
    Yk = jnp.transpose(Y, (2, 0, 1))  # (K, N, T)
    # F: (K, N*taps, T) delayed stacks
    rows = []
    for tau in range(taps):
        shift = delay + tau
        rows.append(jnp.pad(Yk[:, :, : T - shift], ((0, 0), (0, 0), (shift, 0))))
    F = jnp.concatenate(rows, axis=1)  # (K, N*taps, T)

    D = Yk
    for _ in range(iters):
        lam = jnp.maximum(jnp.mean(jnp.abs(D) ** 2, axis=1), eps)       # (K, T)
        Fw = F / lam[:, None, :].astype(F.real.dtype)
        R = jnp.einsum("kit,kjt->kij", Fw, jnp.conj(F))                  # (K, NT, NT)
        Pm = jnp.einsum("kit,knt->kin", Fw, jnp.conj(Yk))                # (K, NT, N)
        tr = jnp.real(jnp.trace(R, axis1=1, axis2=2))[:, None, None]
        ridge = (eps * tr / R.shape[1]) * jnp.eye(R.shape[1], dtype=R.dtype)
        G = jnp.linalg.solve(R + ridge, Pm)                              # (K, NT, N)
        D = Yk - jnp.einsum("kin,kit->knt", jnp.conj(G), F)
    return jnp.transpose(D, (1, 2, 0))
