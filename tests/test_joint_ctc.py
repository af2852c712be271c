"""Config-5 joint training gates (models/joint.py): CTC loss must
backpropagate through the mask-MVDR front-end, and training the
front-end JOINTLY must beat freezing it at random init on held-out CTC
loss (margins frozen from tools/exp_joint_ctc.py, where joint reaches
1.66 vs untrained 2.34 train loss at 400 steps and the gap widens with
steps; see the committed table in JOINT.md)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

pytest.importorskip("flax")  # dsr.models needs it; the core does not

from dsr.config import FilterbankConfig
from dsr.models import joint as mj
from dsr.models.conformer import ctc_loss
from dsr.ops import filterbank as jfb
from tools.exp_joint_ctc import build_data

STEPS = 250


@pytest.fixture(scope="module")
def data():
    from golden import corpus as gcorpus

    cfg = FilterbankConfig(M=64, m=2, r=2)
    Xtr, lab_tr, len_tr, _, _, _, _ = build_data(jnp, jfb, cfg, 14, seed=0)
    Xev, lab_ev, len_ev, _, _, _, _ = build_data(jnp, jfb, cfg, 8, seed=500)
    model = mj.JointBeamformerCtc(vocab=len(gcorpus.VOCAB), subbands_m=cfg.M)
    params0 = model.init(jax.random.PRNGKey(0), Xtr[:1])
    return model, params0, (Xtr, lab_tr, len_tr), (Xev, lab_ev, len_ev)


def _eval_loss(model, params, ev):
    Xev, lab, lens = ev
    logits = model.apply(params, Xev)
    B, T = logits.shape[0], logits.shape[1]
    return float(ctc_loss(logits, jnp.full((B,), T, jnp.int32),
                          jnp.asarray(lab), jnp.asarray(lens)))


def _train(model, params0, tr, frozen, steps=STEPS):
    # NO gradient clip here: at this short horizon the clip throttles the
    # front-end's learning and the ablation stops separating (clipping is
    # needed only for the LONG from-scratch runs in tools/exp_joint_ctc.py,
    # where unclipped training eventually NaNs through the MVDR solve)
    tx = optax.adam(3e-3)
    step = mj.make_train_step(model, tx, frozen_frontend=frozen)
    p, o = params0, tx.init(params0)
    Xtr, lab, lens = tr
    for _ in range(steps):
        p, o, l = step(p, o, Xtr, jnp.asarray(lab), jnp.asarray(lens))
    return p, float(l)


def test_gradients_reach_the_mask_estimator(data):
    model, params0, tr, _ = data
    Xtr, lab, lens = tr

    def loss_fn(p):
        logits = model.apply(p, Xtr[:2])
        B, T = logits.shape[0], logits.shape[1]
        return ctc_loss(logits, jnp.full((B,), T, jnp.int32),
                        jnp.asarray(lab[:2]), jnp.asarray(lens[:2]))

    grads = jax.grad(loss_fn)(params0)
    leaves = jax.tree_util.tree_leaves(grads["params"]["frontend"])
    norms = [float(jnp.linalg.norm(g)) for g in leaves]
    assert all(np.isfinite(n) for n in norms)
    assert max(norms) > 1e-6, "CTC loss must reach the mask estimator"


def test_joint_training_beats_frozen_untrained_frontend(data):
    """Config 5's defining clause — the front-end is LEARNED: from a
    shared warm start (AM trained with the mask estimator frozen at
    random init), continuing JOINTLY must beat continuing with the
    front-end still frozen on held-out CTC loss by a concrete margin.
    The shared warmup isolates the front-end-learning contribution
    (plain from-scratch joint-vs-frozen is two-timescale noisy at test
    sizes; tools/exp_joint_ctc.py carries the from-scratch table)."""
    model, params0, tr, ev = data
    p_warm, _ = _train(model, params0, tr, frozen=True, steps=STEPS)
    p_joint, _ = _train(model, p_warm, tr, frozen=False, steps=STEPS)
    p_froz, _ = _train(model, p_warm, tr, frozen=True, steps=STEPS)
    ev_joint = _eval_loss(model, p_joint, ev)
    ev_froz = _eval_loss(model, p_froz, ev)
    assert np.isfinite(ev_joint) and np.isfinite(ev_froz)
    assert ev_joint < ev_froz - 0.1, (
        f"joint {ev_joint:.3f} vs frozen-untrained {ev_froz:.3f}")
    # and the frontend actually moved
    d = jax.tree_util.tree_map(
        lambda a, b: float(jnp.max(jnp.abs(a - b))),
        p_joint["params"]["frontend"], params0["params"]["frontend"])
    assert max(jax.tree_util.tree_leaves(d)) > 1e-4
