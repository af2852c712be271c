"""Degree-split decoder parity (asr/decoder/split_decoder.py): identical
words to the dense top-K decoder, with the overflow certificate accounting
for any divergence."""

import numpy as np
import jax.numpy as jnp
import pytest

from dsr.asr import lvcsr
from dsr.asr.decoder import split_decoder as sd
from dsr.asr.decoder import topk_decoder as tk
from dsr.asr.fsm import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native WFST core not built"
)


@pytest.fixture(scope="module")
def task():
    return lvcsr.build_task(
        lvcsr.LvcsrConfig(vocab_size=300, n_tokens=5000, branching=3))


def test_split_packing_covers_all_arcs(task):
    g = task.graph
    sp = sd.build_split_graph(g)
    deg = np.bincount(g.src, minlength=g.num_states)
    # every arc lands exactly once: finite-weight count matches
    n_main = int((np.asarray(sp.packed[:, :sd.A0]).view(np.float32) > sd.NEG / 2).sum())
    n_ov = int((np.asarray(sp.ov_packed[:, :sd.A0]).view(np.float32) > sd.NEG / 2).sum())
    assert n_main + n_ov == g.num_arcs
    assert n_main == int(np.minimum(deg, sd.A0).sum())


def test_split_decode_matches_dense(task):
    tg = tk.build_token_graph(task.graph)
    sp = sd.build_split_graph(task.graph)
    rng = np.random.default_rng(0)
    params = lvcsr.synthetic_am(task, var=4.0)
    rng0 = np.random.default_rng(task.cfg.seed)
    lex = lvcsr.make_lexicon(task.cfg.vocab_size, rng0)
    text = lvcsr.make_text(sorted(lex), task.cfg.n_tokens,
                           task.cfg.branching, rng0)
    from dsr.asr.am import gmm as jgmm

    for i in range(3):
        feats = lvcsr.synthesize_utterance(task, text[i][:5], rng, noise=2.0)
        ll = jgmm.loglik(params, jnp.asarray(feats))
        od, scd = tk.decode(tg, ll, kcap=256, beam=60.0)
        os_, scs, ovf = sd.decode_split(sp, ll, kcap=256, beam=60.0)
        wd = [int(w) for w in np.asarray(od) if w]
        ws = [int(w) for w in np.asarray(os_) if w]
        assert int(ovf) == 0, "EG budget must cover this graph's decodes"
        assert ws == wd, (i, ws, wd)
        assert abs(float(scs) - float(scd)) < 2e-2

@pytest.mark.parametrize("a0", [2, 4])
def test_split_decode_a0_variants_match_dense(task, a0):
    """The main-width sweep machinery: narrower main tables pack
    and decode exactly like the default, with the overflow budget sized
    for the extra group demand."""
    tg = tk.build_token_graph(task.graph)
    sp = sd.build_split_graph(task.graph, a0=a0)
    deg = np.bincount(task.graph.src, minlength=task.graph.num_states)
    n_main = int((np.asarray(sp.packed[:, :a0]).view(np.float32) > sd.NEG / 2).sum())
    n_ov = int((np.asarray(sp.ov_packed[:, :a0]).view(np.float32) > sd.NEG / 2).sum())
    assert n_main + n_ov == task.graph.num_arcs
    assert n_main == int(np.minimum(deg, a0).sum())
    rng = np.random.default_rng(1)
    params = lvcsr.synthetic_am(task, var=4.0)
    rng0 = np.random.default_rng(task.cfg.seed)
    lex = lvcsr.make_lexicon(task.cfg.vocab_size, rng0)
    text = lvcsr.make_text(sorted(lex), task.cfg.n_tokens,
                           task.cfg.branching, rng0)
    from dsr.asr.am import gmm as jgmm

    feats = lvcsr.synthesize_utterance(task, text[3][:5], rng, noise=2.0)
    ll = jgmm.loglik(params, jnp.asarray(feats))
    od, scd = tk.decode(tg, ll, kcap=256, beam=60.0)
    os_, scs, ovf = sd.decode_split(sp, ll, kcap=256, beam=60.0,
                                    eg=2048 // a0)
    assert int(ovf) == 0, "EG budget must cover the narrower main table"
    assert [int(w) for w in np.asarray(os_) if w] == \
        [int(w) for w in np.asarray(od) if w]
    assert abs(float(scs) - float(scd)) < 2e-2
