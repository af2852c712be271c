"""Joint neural-beamformer + Conformer-CTC training — BASELINE.json
config 5's defining clause: "Conformer-CTC acoustic model with LEARNED
neural beamforming front-end", trained END-TO-END (round-4 VERDICT item
3; SURVEY.md §7 step 10).

One differentiable path: multi-channel subband snapshots → mask-MVDR
(models/neural_beamformer.py — gradients flow through the masked-PSD
solve into the mask estimator) → subband MFCC + CMN (ops/features.py,
all matmuls) → ConformerCtc → optax CTC loss.  `train_step` updates BOTH
parameter subtrees in one jitted step; dp over the utterance batch is
the mesh layout (`__graft_entry__.dryrun_multichip` runs this step
data-parallel).

tools/exp_joint_ctc.py + tests/test_joint_ctc.py gate that joint
training beats a frozen untrained-mask front-end and stays within slack
of (or beats) a frozen ORACLE-steered MVDR front-end on greedy WER over
the image-source reverberant corpus.
"""

from __future__ import annotations

import functools
from typing import Any

import flax.linen as nn
import jax
import jax.numpy as jnp

from dsr.models.conformer import ConformerCtc, ctc_loss
from dsr.models.neural_beamformer import NeuralBeamformer
from dsr.ops import features as jft


class JointBeamformerCtc(nn.Module):
    """(B, N, T, K) complex subband snapshots → CTC logits.

    Parameters split into the `NeuralBeamformer` (mask estimator) and
    `ConformerCtc` subtrees; both receive gradients from the CTC loss.
    """

    vocab: int
    subbands_m: int                 # filterbank M (for the mel projection)
    sample_rate: float = 16000.0
    dim: int = 64
    layers: int = 2
    heads: int = 2
    hidden: int = 64

    @nn.compact
    def __call__(self, X):
        nb = nn.vmap(NeuralBeamformer,
                     in_axes=0, out_axes=0,
                     variable_axes={"params": None},
                     split_rngs={"params": False})(self.hidden,
                                                   name="frontend")
        enh = nb(X)                                        # (B, T, K)
        feats = jft.mfcc_from_subbands(enh, self.subbands_m,
                                       self.sample_rate)
        feats = jft.cmn(feats)
        return ConformerCtc(vocab=self.vocab, dim=self.dim,
                            layers=self.layers, heads=self.heads,
                            name="am")(feats)


def make_train_step(model: JointBeamformerCtc, tx, frozen_frontend=False):
    """Jitted (params, opt_state, X, labels, label_lens[, frame_lens]) →
    (params, opt_state, loss).  frozen_frontend=True zeroes the frontend
    update — the ablation baselines (untrained mask / oracle front-end)
    train the AM with the identical step.

    frame_lens (B,) gives each utterance's VALID subband-frame count in
    X's T axis; CTC then masks the padded logit frames (the Conformer
    subsamples 4×, so valid logits = ceil(frames/4)).  Omitted, every
    frame counts — only correct for unpadded equal-length batches."""

    def loss_fn(params, X, labels, label_lens, frame_lens):
        logits = model.apply(params, X)
        B, T = logits.shape[0], logits.shape[1]
        if frame_lens is None:
            llen = jnp.full((B,), T, jnp.int32)
        else:
            llen = jnp.minimum((frame_lens + 3) // 4, T).astype(jnp.int32)
        return ctc_loss(logits, llen, labels, label_lens)

    @jax.jit
    def step(params, opt_state, X, labels, label_lens, frame_lens=None):
        loss, grads = jax.value_and_grad(loss_fn)(params, X, labels,
                                                  label_lens, frame_lens)
        if frozen_frontend:
            grads = jax.tree_util.tree_map_with_path(
                lambda path, g: (jnp.zeros_like(g)
                                 if any(getattr(p, "key", None) == "frontend"
                                        for p in path) else g), grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        import optax
        return optax.apply_updates(params, updates), opt_state, loss

    return step


class OracleMvdrCtc(nn.Module):
    """Baseline front-end for the config-5 gates: FIXED oracle-steered
    MVDR weights (computed outside from the true source position), then
    the same features + ConformerCtc."""

    vocab: int
    subbands_m: int
    sample_rate: float = 16000.0
    dim: int = 64
    layers: int = 2
    heads: int = 2

    @nn.compact
    def __call__(self, X, w):
        # X (B, N, T, K), w (K, N) fixed beamformer weights
        enh = jnp.einsum("kn,bntk->btk", jnp.conj(w), X)
        feats = jft.cmn(jft.mfcc_from_subbands(enh, self.subbands_m,
                                               self.sample_rate))
        return ConformerCtc(vocab=self.vocab, dim=self.dim,
                            layers=self.layers, heads=self.heads,
                            name="am")(feats)
