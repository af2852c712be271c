"""MLLR regression classes (VERDICT r2 missing #4 / next-round #6):
a 2-cluster speaker shift must be recovered by 2-class MLLR but NOT by the
single global transform, and data-poor classes must back off up the tree."""

import numpy as np
import jax.numpy as jnp

from dsr.asr.adapt import mllr
from dsr.asr.am.gmm import GmmParams
from dsr.asr.train.ml import GmmAccum

S, C, D = 24, 1, 4


def make_model(seed=0):
    """Two acoustic clusters of Gaussians (e.g. vowels vs fricatives)."""
    rng = np.random.default_rng(seed)
    centers = np.asarray([[4.0, 4, 4, 4], [-4.0, -4, -4, -4]])
    mu = np.stack([centers[s % 2] + rng.normal(0, 1.0, D) for s in range(S)])
    params = GmmParams(
        jnp.asarray(mu[:, None, :].astype(np.float32)),
        jnp.full((S, C, D), 0.5, jnp.float32),
        jnp.zeros((S, C), jnp.float32),
    )
    group = np.arange(S) % 2
    return params, group


def speaker_stats(params, group, occ_per_gauss, shifts):
    """Adaptation stats as if the speaker shifted each cluster's means by
    its own offset: observed mean of Gaussian g = μ_g + shift[group(g)]."""
    mu = np.asarray(params.means)[:, 0, :]
    occ = np.asarray(occ_per_gauss, np.float32)
    target = mu + np.asarray(shifts)[group]
    sx = occ[:, None] * target
    sxx = occ[:, None] * (target ** 2 + 0.5)
    return GmmAccum(jnp.asarray(occ[:, None]),
                    jnp.asarray(sx[:, None].astype(np.float32)),
                    jnp.asarray(sxx[:, None].astype(np.float32))), target


def test_two_class_recovers_what_global_cannot():
    params, group = make_model()
    shifts = np.asarray([[2.0, -1.0, 0.5, 1.5], [-1.5, 2.0, -0.5, -2.0]])
    acc, target = speaker_stats(params, group, np.full(S, 200.0), shifts)

    Wg = mllr.estimate_mllr(params, acc)
    glob = np.asarray(mllr.apply_mllr(params, Wg).means)[:, 0, :]
    err_global = np.abs(glob - target).max()

    tree = mllr.build_regression_tree(params, acc.occ, n_leaves=2)
    # the occupancy-weighted split must discover the two acoustic clusters
    leaf_ids = tree.leaf_of
    assert len(set(zip(group.tolist(), leaf_ids.tolist()))) == 2

    W_node, class_W = mllr.estimate_mllr_regclass(params, acc, tree,
                                                  min_occ=50.0)
    ad = np.asarray(mllr.apply_mllr_regclass(params, W_node, class_W).means)
    err_class = np.abs(ad[:, 0, :] - target).max()

    assert err_class < 2e-2, err_class
    assert err_global > 0.5, err_global        # one affine can't fit both


def test_low_occupancy_class_backs_off_to_global():
    params, group = make_model(1)
    shifts = np.asarray([[1.0, 1, 1, 1], [-1.0, -1, -1, -1]])
    occ = np.where(group == 0, 300.0, 2.0)     # cluster 1: almost no data
    acc, _ = speaker_stats(params, group, occ, shifts)
    tree = mllr.build_regression_tree(params, acc.occ, n_leaves=2)
    W_node, class_W = mllr.estimate_mllr_regclass(params, acc, tree,
                                                  min_occ=50.0)
    cls = np.asarray(class_W)
    rich = {int(c) for c in cls[group == 0]}
    poor = {int(c) for c in cls[group == 1]}
    assert poor == {0}, poor                   # backs off to the root
    assert rich != {0}                         # data-rich leaf keeps its own


def test_many_leaves_match_global_when_shift_is_uniform():
    """A uniform speaker shift: every class's transform equals the global
    one (sanity: regression classes add freedom, not bias)."""
    params, group = make_model(2)
    shifts = np.asarray([[0.7, -0.2, 0.1, 0.4]] * 2)
    acc, target = speaker_stats(params, group, np.full(S, 200.0), shifts)
    tree = mllr.build_regression_tree(params, acc.occ, n_leaves=4)
    W_node, class_W = mllr.estimate_mllr_regclass(params, acc, tree,
                                                  min_occ=10.0)
    ad = np.asarray(mllr.apply_mllr_regclass(params, W_node, class_W).means)
    assert np.abs(ad[:, 0, :] - target).max() < 5e-2
