"""TDE / localization / tracking gates: golden parity + physical accuracy
on simulated moving/static sources (config 3 front end)."""

import numpy as np
import jax.numpy as jnp
import pytest

from golden import room as groom
from golden import tde as gtde
from golden import tracking as gtrack
from dsr.config import ArrayGeometry
from dsr.ops import tde as jtde
from dsr.ops import tracking as jtrack

SR = 16000.0
GEOM = ArrayGeometry.circular(8, 0.15)
POS = np.asarray(GEOM.positions)
PAIRS = [(i, j) for i in range(8) for j in range(i + 1, 8)]
PI = np.asarray([p[0] for p in PAIRS])
PJ = np.asarray([p[1] for p in PAIRS])


def _sim(src_pos, seed=0, S=8192, snr=20.0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(S)
    return groom.simulate(src, POS, src_pos, SR, snr_db=snr, rng=rng)


def test_gcc_phat_accuracy_and_parity():
    pos = np.array([1.2, 1.7, 0.1])
    x = _sim(pos)
    true = gtde.expected_tdoas(pos, POS, PAIRS, 343.0)
    tau_g = gtde.pair_tdoas(x, PAIRS, SR, max_tau=0.005)
    tau_j = np.asarray(jtde.gcc_phat_pairs(x.astype(np.float32), PAIRS, SR, max_tau=0.005))
    # physical accuracy: within half a sample
    assert np.max(np.abs(tau_g - true)) < 0.5 / SR
    assert np.max(np.abs(tau_j - true)) < 0.5 / SR
    # golden/jax parity: within a tenth of a sample
    assert np.max(np.abs(tau_j - tau_g)) < 0.1 / SR


def test_srp_phat_finds_source():
    pos = np.array([0.8, 1.4, 0.0])
    x = _sim(pos, seed=1)
    gx, gy = np.meshgrid(np.linspace(-1.5, 1.5, 13), np.linspace(0.5, 2.5, 9))
    grid = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], axis=1)
    best_g, pow_g = gtde.srp_phat(x, POS, grid, SR)
    best_j, pow_j = jtde.srp_phat(x.astype(np.float32), POS, grid, SR)

    # a 0.15 m aperture resolves BEARING, not range — assert direction only
    def bearing_err(p):
        a = np.arctan2(p[1], p[0])
        b = np.arctan2(pos[1], pos[0])
        return abs(np.angle(np.exp(1j * (a - b))))

    assert bearing_err(best_g) < 0.3
    assert bearing_err(np.asarray(best_j)) < 0.3
    # parity of the power surface shape
    cg = np.corrcoef(pow_g, np.asarray(pow_j))[0, 1]
    assert cg > 0.999


def test_ls_position_from_tdoas():
    # planar array: z unobservable (sign symmetric) — keep the source in-plane
    pos = np.array([0.9, 1.1, 0.0])
    true = gtde.expected_tdoas(pos, POS, PAIRS, 343.0)
    est_g = gtde.ls_position(true, POS, PAIRS)
    est_j = np.asarray(
        jtde.ls_position(
            true.astype(np.float32), POS.astype(np.float32), PI, PJ,
            np.array([0.0, 1.0, 0.0], np.float32),
        )
    )
    assert np.linalg.norm(est_g - pos) < 1e-3
    assert np.linalg.norm(est_j - pos) < 1e-2


def test_iekf_tracks_moving_source_and_parity():
    rng = np.random.default_rng(3)
    T = 40
    path = np.stack(
        [
            0.5 + 0.8 * np.linspace(0, 1, T),
            1.5 + 0.3 * np.sin(np.linspace(0, 3, T)),
            np.zeros(T),
        ],
        axis=1,
    )
    obs = np.stack(
        [gtde.expected_tdoas(p, POS, PAIRS, 343.0) for p in path]
    ) + rng.standard_normal((T, len(PAIRS))) * 2e-6
    x0 = np.array([0.0, 1.0, 0.0])
    P0 = np.eye(3) * 0.5
    q, r = 1e-3, (5e-6) ** 2
    trk = gtrack.IekfTracker(x0, P0, q, r, POS, PAIRS)
    est_g = np.stack([trk.step(o) for o in obs])
    est_j = np.asarray(
        jtrack.track(
            obs.astype(np.float32), x0.astype(np.float32), P0.astype(np.float32),
            POS.astype(np.float32), PI, PJ, q, r,
        )
    )
    # converges to the true trajectory
    assert np.linalg.norm(est_g[-10:] - path[-10:], axis=1).mean() < 0.05
    assert np.linalg.norm(est_j[-10:] - path[-10:], axis=1).mean() < 0.05
    # golden/jax parity (f32 vs f64 tolerance)
    assert np.max(np.abs(est_g - est_j)) < 5e-3


def test_tracking_to_steering_closes_loop():
    """Config-3 loop: tracked position → steering delays ≈ geometry truth."""
    pos = np.array([1.0, 1.5, 0.0])
    taus_true = groom.steering_delays(POS, pos, 343.0, SR) / SR
    taus_j = np.asarray(
        jtrack.steering_delays_from_position(
            pos.astype(np.float32), POS.astype(np.float32)
        )
    )
    assert np.max(np.abs(taus_true - taus_j)) < 1e-7


def test_sx_position_closed_form():
    """Spherical-intersection localiser: exact recovery from clean TDOAs,
    jax == golden, and graceful degradation under TDOA noise."""
    rng = np.random.default_rng(3)
    mics = np.array([
        [0.0, 0.0, 0.0], [0.3, 0.0, 0.0], [0.0, 0.3, 0.0], [0.3, 0.3, 0.0],
        [0.0, 0.0, 0.25], [0.3, 0.0, 0.25], [0.0, 0.3, 0.25], [0.3, 0.3, 0.25],
    ])
    pos = np.array([1.2, 2.1, 0.7])
    pairs = [(0, i) for i in range(1, len(mics))]
    taus = gtde.expected_tdoas(pos, mics, pairs, 343.0)
    x_g = gtde.sx_position(taus, mics)
    x_j = np.asarray(jtde.sx_position(jnp.asarray(taus, jnp.float32),
                                      jnp.asarray(mics, jnp.float32)))
    assert np.linalg.norm(x_g - pos) < 1e-6
    assert np.linalg.norm(x_j - pos) < 5e-2      # f32 pinv
    assert np.linalg.norm(x_j - x_g) < 5e-2
    # under TDOA noise the small-aperture range is ill-conditioned (as for
    # any TDOA solver) but the BEARING stays accurate — that is what the
    # tracker consumes (steering delays).  1 µs TDOA noise → < 1° bearing.
    ctr = mics.mean(0)
    x_n = gtde.sx_position(taus + rng.normal(0, 1e-6, len(taus)), mics)
    u = (x_n - ctr) / np.linalg.norm(x_n - ctr)
    v = (pos - ctr) / np.linalg.norm(pos - ctr)
    assert np.degrees(np.arccos(np.clip(u @ v, -1, 1))) < 1.0


def test_sqrt_iekf_matches_full_covariance_iekf():
    """Square-root (QR/Kailath-array) propagation ≡ Joseph-form IEKF."""
    rng = np.random.default_rng(5)
    T = 30
    path = np.stack(
        [
            0.4 + 0.6 * np.linspace(0, 1, T),
            1.2 + 0.2 * np.cos(np.linspace(0, 2, T)),
            np.zeros(T),
        ],
        axis=1,
    )
    obs = np.stack(
        [gtde.expected_tdoas(p, POS, PAIRS, 343.0) for p in path]
    ) + rng.standard_normal((T, len(PAIRS))) * 2e-6
    x0 = np.array([0.0, 1.0, 0.0])
    P0 = np.eye(3) * 0.5
    q, r = 1e-3, (5e-6) ** 2

    # golden: full-covariance vs square-root trackers agree step-by-step
    trk_full = gtrack.IekfTracker(x0, P0, q, r, POS, PAIRS)
    trk_sqrt = gtrack.SqrtIekfTracker(x0, np.linalg.cholesky(P0), q, r, POS, PAIRS)
    est_full = np.stack([trk_full.step(o) for o in obs])
    est_sqrt = np.stack([trk_sqrt.step(o) for o in obs])
    assert np.max(np.abs(est_full - est_sqrt)) < 1e-8
    # the factor really is chol(P): S Sᵀ == P of the full filter
    assert np.max(np.abs(trk_sqrt.S @ trk_sqrt.S.T - trk_full.P)) < 1e-10

    # jax square-root scan: parity with golden (f32 vs f64)
    est_j = np.asarray(
        jtrack.track_sqrt(
            obs.astype(np.float32), x0.astype(np.float32),
            np.linalg.cholesky(P0).astype(np.float32),
            POS.astype(np.float32), PI, PJ, q, r,
        )
    )
    assert np.max(np.abs(est_sqrt - est_j)) < 5e-3
    # and it tracks
    assert np.linalg.norm(est_j[-10:] - path[-10:], axis=1).mean() < 0.05
