"""Gate for the decoder's shipped pruning defaults (round-2 VERDICT item
4; the LVCSR-scale curve lives in PRUNING.md via tools/exp_wer_prune.py).

On a noisy (well-calibrated) synthetic corpus through the 43k-state
trigram HCLG: kcap=256 must sit within 1% absolute WER of kcap=512, the
beam default must not be the binding constraint, and the degree-split
production decoder must match the dense decoder's WER at the default
operating point."""

import numpy as np
import pytest

from dsr.asr import lvcsr
from dsr.asr.decoder import topk_decoder as tk
from dsr.asr.fsm import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native WFST core not built"
)

NOISE = 2.2


@pytest.fixture(scope="module")
def setup():
    import jax.numpy as jnp
    from dsr.asr.am import gmm as jgmm

    cfg = lvcsr.LvcsrConfig(vocab_size=300, n_tokens=5000, branching=3)
    task = lvcsr.build_task(cfg)
    tg = tk.build_token_graph(task.graph)
    rng0 = np.random.default_rng(cfg.seed)
    lex = lvcsr.make_lexicon(cfg.vocab_size, rng0)
    text = lvcsr.make_text(sorted(lex), cfg.n_tokens, cfg.branching, rng0)
    sents = [text[i][:5] for i in range(5)]
    rng = np.random.default_rng(23)
    params = lvcsr.synthetic_am(task, var=NOISE ** 2)
    feats = [lvcsr.synthesize_utterance(task, s, rng, noise=NOISE)
             for s in sents]
    T = max(f.shape[0] for f in feats)
    lens = np.asarray([f.shape[0] for f in feats], np.int32)
    batch = np.zeros((len(feats), T, task.num_pdfs), np.float32)
    for i, f in enumerate(feats):
        batch[i, : f.shape[0]] = f
    ll = jgmm.loglik(params, jnp.asarray(batch.reshape(-1, task.num_pdfs)))
    ll = jnp.reshape(ll, batch.shape[:2] + (task.num_pdfs,))
    return task, tg, sents, ll, lens


def wer(task, sents, olabs, lens):
    from dsr.utils.metrics import WerScorer

    sc = WerScorer()
    for i, s in enumerate(sents):
        hyp = [task.words.name(int(w))
               for w in np.asarray(olabs[i][: lens[i]]) if w]
        sc.add(s, hyp)
    return sc.wer


def test_kcap_256_matches_512(setup):
    task, tg, sents, ll, lens = setup
    o256, _ = tk.decode_batch(tg, ll, lens, kcap=256, beam=60.0)
    o512, _ = tk.decode_batch(tg, ll, lens, kcap=512, beam=60.0)
    w256, w512 = wer(task, sents, o256, lens), wer(task, sents, o512, lens)
    assert w256 <= w512 + 0.01, (w256, w512)


def test_beam_default_not_binding(setup):
    task, tg, sents, ll, lens = setup
    o60, _ = tk.decode_batch(tg, ll, lens, kcap=256, beam=60.0)
    oinf, _ = tk.decode_batch(tg, ll, lens, kcap=256, beam=1e9)
    assert wer(task, sents, o60, lens) <= wer(task, sents, oinf, lens) + 0.01


def test_pallas_select_wer_neutral(setup):
    """The degree-split decoder (the bench's a0=2 / eg=896 layout) decodes
    the same words as the dense decoder at kcap=256, beam=60, with no
    overflow frames."""
    from dsr.asr.decoder import split_decoder as sd

    task, tg, sents, ll, lens = setup
    od, _ = tk.decode_batch(tg, ll, lens, kcap=256, beam=60.0)
    sg = sd.build_split_graph(task.graph, a0=2)
    osp, _, ovf = sd.decode_batch_split(sg, ll, lens, kcap=256, beam=60.0,
                                        eg=896)
    assert int(np.asarray(ovf).sum()) == 0
    for i in range(len(sents)):
        assert ([int(w) for w in np.asarray(osp[i][: lens[i]]) if w]
                == [int(w) for w in np.asarray(od[i][: lens[i]]) if w])
    assert wer(task, sents, osp, lens) == wer(task, sents, od, lens)
