"""Speech-activity detection (energy + Sohn likelihood-ratio).

Numerics match `golden/sad.py` (reference `btk/sad/` [K]).  Both detectors
are `lax.scan`s over frames (the floor tracker / decision-directed prior
are genuine recurrences); per-frame work is vectorised over subbands.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def energy_vad(P_frames, threshold_db: float = 6.0, hangover: int = 8):
    """P_frames: (T,) frame powers → (T,) int32 decisions."""
    logp = 10.0 * jnp.log10(jnp.maximum(P_frames, 1e-12))

    def step(carry, lp):
        floor, hang = carry
        floor = jnp.where(lp < floor, 0.9 * floor + 0.1 * lp, floor + 0.05)
        active = lp > floor + threshold_db
        dec = active | (hang > 0)
        hang = jnp.where(active, hangover, jnp.maximum(hang - 1, 0))
        return (floor, hang), dec.astype(jnp.int32)

    _, out = jax.lax.scan(step, (logp[0], jnp.int32(0)), logp)
    return out


@jax.jit
def sohn_vad(
    P,
    noise_psd,
    prior_snr_alpha: float = 0.98,
    threshold: float = 0.0,
    hangover: int = 8,
):
    """P: (T, K) powers; noise_psd: (K,) → (decisions (T,), llr (T,))."""

    def step(carry, p):
        gain_prev, hang = carry
        gamma = p / jnp.maximum(noise_psd, 1e-12)
        xi = prior_snr_alpha * gain_prev**2 * gamma + (1 - prior_snr_alpha) * jnp.maximum(
            gamma - 1, 0
        )
        xi = jnp.maximum(xi, 1e-3)
        llr = jnp.mean(gamma * xi / (1 + xi) - jnp.log1p(xi))
        gain = xi / (1 + xi)
        active = llr > threshold
        dec = active | (hang > 0)
        hang = jnp.where(active, hangover, jnp.maximum(hang - 1, 0))
        return (gain, hang), (dec.astype(jnp.int32), llr)

    K = P.shape[1]
    (_, _), (dec, llr) = jax.lax.scan(step, (jnp.ones(K), jnp.int32(0)), P)
    return dec, llr


def segments_from_vad(decisions, min_speech: int = 10, min_gap: int = 15,
                      pad: int = 5):
    """Utterance segmenter over frame-level VAD decisions (the reference's
    segmenter role, SURVEY.md appendix).

    Merges speech runs separated by < min_gap silence frames, drops runs
    shorter than min_speech, and pads each segment by `pad` frames.
    Returns [(start_frame, end_frame)].  Host-side (numpy/list) utility.
    """
    import numpy as np

    d = np.asarray(decisions).astype(bool)
    T = len(d)
    runs = []
    t = 0
    while t < T:
        if d[t]:
            s = t
            while t < T and d[t]:
                t += 1
            runs.append([s, t])
        else:
            t += 1
    # merge close runs
    merged = []
    for r in runs:
        if merged and r[0] - merged[-1][1] < min_gap:
            merged[-1][1] = r[1]
        else:
            merged.append(r)
    out = []
    for s, e in merged:
        if e - s >= min_speech:
            out.append((max(0, s - pad), min(T, e + pad)))
    return out
