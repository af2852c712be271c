"""MLLR mean-transform adaptation (reference `asr/adapt/` MLLR [K]).

Per regression class, the mean transform W (D × D+1) maximising the EM
auxiliary for diagonal-covariance GMMs has the classic row-wise closed
form:  for each dim d,   w_d = G_d⁻¹ k_d   with
    G_d = Σ_g occ_g / σ²_{g,d} · ξ_g ξ_gᵀ          (ξ_g = [1, μ_g])
    k_d = Σ_g sx_{g,d} / σ²_{g,d} · ξ_g
computed straight from the standard ML accumulators (occ, Σγx) — the same
statistics `train.ml.accumulate` already produces.  Adapted means:
μ' = W ξ.  Design: all sums are einsums over (S·C) Gaussians; the D
row-solves are one batched `jnp.linalg.solve`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# stats einsums are offline and accuracy-critical: reduced-precision
# products put 0.26 abs error on recovered means
_HI = jax.lax.Precision.HIGHEST

from dsr.asr.am.gmm import GmmParams
from dsr.asr.train.ml import GmmAccum


@jax.jit
def estimate_mllr(params: GmmParams, acc: GmmAccum, reg: float = 1e-4) -> jnp.ndarray:
    """→ W (D, D+1) global-class MLLR mean transform."""
    S, C, D = params.means.shape
    mu = params.means.reshape(S * C, D)
    inv_v = (1.0 / params.variances).reshape(S * C, D)
    occ = acc.occ.reshape(S * C)
    sx = acc.sx.reshape(S * C, D)
    xi = jnp.concatenate([jnp.ones((S * C, 1)), mu], axis=1)          # (G, D+1)
    # G_d = Σ_g occ_g invv_{g,d} ξ_g ξ_gᵀ   → (D, D+1, D+1)
    Gd = jnp.einsum("g,gd,gi,gj->dij", occ, inv_v, xi, xi, precision=_HI)
    kd = jnp.einsum("gd,gd,gi->di", sx, inv_v, xi, precision=_HI)
    Gd = Gd + reg * jnp.eye(D + 1)[None]
    W = jnp.linalg.solve(Gd, kd[..., None])[..., 0]                   # (D, D+1)
    return W


@jax.jit
def apply_mllr(params: GmmParams, W: jnp.ndarray) -> GmmParams:
    """Transform all means: μ' = W [1, μ]."""
    S, C, D = params.means.shape
    mu = params.means.reshape(S * C, D)
    xi = jnp.concatenate([jnp.ones((S * C, 1)), mu], axis=1)
    mu2 = xi @ W.T
    return GmmParams(mu2.reshape(S, C, D), params.variances, params.logweights)


# ---------------------------------------------------------------------------
# Regression classes (reference `asr/adapt/` MLLR regression-class
# transforms [K]): Gaussians are clustered into a binary regression tree by
# acoustic similarity of their means (geometric 2-means splits, the
# largest-occupancy leaf split first); each leaf with enough adaptation data gets
# its own W, data-poor leaves back off to the closest ancestor with
# sufficient occupancy — the root is the global transform above.
# Tree building is an offline model-prep step (host numpy); estimation and
# application are jitted einsums over (G, L) one-hot class masks.
# ---------------------------------------------------------------------------

import numpy as np
from typing import NamedTuple


class RegressionTree(NamedTuple):
    leaf_of: np.ndarray    # (G,) leaf NODE id per Gaussian
    parent: np.ndarray     # (n_nodes,) parent node id; root 0 has -1
    n_nodes: int

    @property
    def leaves(self) -> np.ndarray:
        return np.unique(self.leaf_of)


def build_regression_tree(params: GmmParams, occ, n_leaves: int = 4,
                          iters: int = 10, seed: int = 0) -> RegressionTree:
    """Occupancy-weighted binary splitting of the Gaussian means into
    `n_leaves` regression classes; returns the full tree for back-off."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1 (got {iters}): the 2-means "
                         "refinement defines the split assignment")
    S, C, D = params.means.shape
    mu = np.asarray(params.means).reshape(S * C, D)
    w = np.maximum(np.asarray(occ).reshape(S * C), 1e-8)
    rng = np.random.default_rng(seed)
    node_of = np.zeros(len(mu), np.int64)      # current leaf node per gauss
    parent = [-1]
    leaf_nodes = [0]

    def split(idx):
        """UNWEIGHTED 2-means of mu[idx] → boolean right-half mask.
        Clustering is geometric on purpose: classes encode acoustic
        similarity; occupancy decides only split order and back-off
        (weighting here makes k-means bisect the data-RICH cluster,
        mixing acoustically distant low-count Gaussians into it)."""
        x = mu[idx]
        m = x.mean(axis=0)
        d = x - m
        v = d[np.argmax(np.einsum("gd,gd->g", d, d))]
        c = np.stack([m - 0.5 * v, m + 0.5 * v])
        for _ in range(iters):
            assign = (np.linalg.norm(x - c[0], axis=1)
                      > np.linalg.norm(x - c[1], axis=1))
            for h in (0, 1):
                sel = assign == bool(h)
                if sel.any():
                    c[h] = x[sel].mean(axis=0)
        if assign.all() or not assign.any():    # degenerate: force a split
            assign = np.zeros(len(idx), bool)
            assign[rng.permutation(len(idx))[: len(idx) // 2]] = True
        return assign

    while len(leaf_nodes) < n_leaves:
        occs = [w[node_of == ln].sum() if (node_of == ln).sum() > 1 else -1.0
                for ln in leaf_nodes]
        pick = int(np.argmax(occs))
        if occs[pick] <= 0:
            break                                # nothing splittable left
        ln = leaf_nodes.pop(pick)
        idx = np.nonzero(node_of == ln)[0]
        right = split(idx)
        a, b = len(parent), len(parent) + 1
        parent.extend([ln, ln])
        node_of[idx[~right]] = a
        node_of[idx[right]] = b
        leaf_nodes.extend([a, b])
    return RegressionTree(node_of, np.asarray(parent), len(parent))


@jax.jit
def _node_stats(params: GmmParams, acc: GmmAccum, leaf_onehot):
    """Per-LEAF MLLR statistics (G_d, k_d, occ) via one masked einsum per
    quantity; ancestors aggregate these on the host (the tree is tiny)."""
    S, C, D = params.means.shape
    mu = params.means.reshape(S * C, D)
    inv_v = (1.0 / params.variances).reshape(S * C, D)
    occ = acc.occ.reshape(S * C)
    sx = acc.sx.reshape(S * C, D)
    xi = jnp.concatenate([jnp.ones((S * C, 1)), mu], axis=1)
    Gd = jnp.einsum("gl,g,gd,gi,gj->ldij", leaf_onehot, occ, inv_v, xi, xi, precision=_HI)
    kd = jnp.einsum("gl,gd,gd,gi->ldi", leaf_onehot, sx, inv_v, xi, precision=_HI)
    o = jnp.einsum("gl,g->l", leaf_onehot, occ, precision=_HI)
    return Gd, kd, o


def estimate_mllr_regclass(params: GmmParams, acc: GmmAccum,
                           tree: RegressionTree, min_occ: float = 100.0,
                           reg: float = 1e-4):
    """Per-regression-class MLLR transforms with occupancy back-off.

    Returns (W_node (n_nodes, D, D+1), class_W (G,) node whose W each
    Gaussian uses).  A leaf with occ ≥ min_occ gets its own transform;
    otherwise it walks up the tree to the first ancestor with enough
    occupancy (the root aggregates everything = the global transform)."""
    leaves = tree.leaves
    L = len(leaves)
    leaf_pos = {int(l): i for i, l in enumerate(leaves)}
    oh = np.zeros((len(tree.leaf_of), L), np.float32)
    oh[np.arange(len(tree.leaf_of)),
       [leaf_pos[int(l)] for l in tree.leaf_of]] = 1.0
    Gd_l, kd_l, occ_l = _node_stats(params, acc, jnp.asarray(oh))
    Gd_l, kd_l, occ_l = map(np.asarray, (Gd_l, kd_l, occ_l))
    D = kd_l.shape[-1] - 1
    # aggregate leaf stats to every ancestor node
    Gd_n = np.zeros((tree.n_nodes,) + Gd_l.shape[1:], Gd_l.dtype)
    kd_n = np.zeros((tree.n_nodes,) + kd_l.shape[1:], kd_l.dtype)
    occ_n = np.zeros(tree.n_nodes, occ_l.dtype)
    for i, ln in enumerate(leaves):
        node = int(ln)
        while node >= 0:
            Gd_n[node] += Gd_l[i]
            kd_n[node] += kd_l[i]
            occ_n[node] += occ_l[i]
            node = int(tree.parent[node])
    Gd_n = Gd_n + reg * np.eye(D + 1)[None, None]
    W_node = np.linalg.solve(Gd_n, kd_n[..., None])[..., 0]  # (n, D, D+1)
    # back-off: node used by each leaf
    use = {}
    for ln in leaves:
        node = int(ln)
        while tree.parent[node] >= 0 and occ_n[node] < min_occ:
            node = int(tree.parent[node])
        use[int(ln)] = node
    class_W = np.asarray([use[int(l)] for l in tree.leaf_of], np.int32)
    return jnp.asarray(W_node), jnp.asarray(class_W)


@jax.jit
def apply_mllr_regclass(params: GmmParams, W_node, class_W) -> GmmParams:
    """μ'_g = W_{class(g)} [1, μ_g] — per-Gaussian transform selection."""
    S, C, D = params.means.shape
    mu = params.means.reshape(S * C, D)
    xi = jnp.concatenate([jnp.ones((S * C, 1)), mu], axis=1)
    Wg = W_node[class_W]                        # (G, D, D+1): tiny gather
    mu2 = jnp.einsum("gdi,gi->gd", Wg, xi, precision=_HI)
    return GmmParams(mu2.reshape(S, C, D), params.variances,
                     params.logweights)
