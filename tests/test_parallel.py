"""Parallelism gates on the 8-device CPU mesh: top-K token passing equals
the dense decoder; graph-sharded decode equals single-device decode."""

import numpy as np
import pytest

import jax

from golden import corpus as gcorpus
from dsr.asr import phone_task
from dsr.asr.am import gmm as jgmm
from dsr.asr.decoder import topk_decoder as tk
from dsr.asr.decoder import wfst_decoder as wd
from dsr.asr.fsm import hclg, lm
from dsr.asr.fsm.packed import pack
from dsr.asr.train import trainer
from dsr.config import MeshConfig
from dsr.ops import features as jft
from dsr.parallel import make_mesh
from dsr.parallel.decoder import make_sharded_decode

SR = 16000.0


def _feats(x):
    return np.asarray(jft.cmn(jft.mfcc(np.asarray(x, np.float32), SR)))


@pytest.fixture(scope="module")
def system():
    task = phone_task.PhoneTask(gcorpus.VOCAB[:6], states_per_phone=2)
    corpus = gcorpus.make_corpus(40, seed=0)
    corpus = [(ws, x) for ws, x in corpus if all(w in task.vocab for w in ws)][:25]
    feats = [_feats(x) for _, x in corpus]
    transcripts = [ws for ws, _ in corpus]
    params = trainer.train(task, feats, transcripts, num_comp=2, iters=3)
    arpa = lm.train_arpa_bigram(transcripts, task.vocab)
    G = lm.arpa_to_fst(arpa, task.words)
    L, ndis = hclg.build_lexicon_fst(task.lexicon, task.phones, task.words, sil_phone="sil")
    H = hclg.build_hmm_fst(len(task.phones) - 1, ndis, states_per_phone=task.spp)
    HCLG = hclg.compose_hclg(H, L, G, len(task.phones) - 1, ndis)
    graph = pack(HCLG)
    eval_corpus = gcorpus.make_corpus(4, seed=55)
    eval_corpus = [(ws, x) for ws, x in eval_corpus if all(w in task.vocab for w in ws)]
    if not eval_corpus:
        eval_corpus = [(transcripts[0], corpus[0][1])]
    lls = [np.asarray(jgmm.loglik(params, _feats(x))) for _, x in eval_corpus]
    return task, graph, lls


def test_topk_equals_dense_when_unpruned(system):
    task, graph, lls = system
    dev = wd.to_device(graph)
    tg = tk.build_token_graph(graph)
    kcap = graph.num_states  # no pruning loss possible
    for ll in lls:
        olabs_d, _, score_d = wd.decode(dev, ll)
        olabs_t, score_t = tk.decode(tg, ll, kcap=kcap)
        hyp_d = wd.words_from_olabels(np.asarray(olabs_d), task.words)
        hyp_t = wd.words_from_olabels(np.asarray(olabs_t), task.words)
        assert hyp_d == hyp_t
        assert abs(float(score_d) - float(score_t)) < 1e-2


def test_topk_pruned_still_reasonable(system):
    task, graph, lls = system
    tg = tk.build_token_graph(graph)
    dev = wd.to_device(graph)
    for ll in lls:
        # kcap=48: the joint eps:eps compose fix enlarged the HCLG (the
        # restored back-off structure), so 24 tokens over-prune it
        olabs_t, score_t = tk.decode(tg, ll, kcap=48, beam=1e9)
        _, _, score_d = wd.decode(dev, ll)
        # pruned search can only lose log-prob mass, and little at kcap=48
        # tolerance is relative: the two decoders sum the same path in
        # different f32 orders
        assert float(score_t) <= float(score_d) + 1e-3 + 1e-6 * abs(float(score_d))
        assert float(score_t) > float(score_d) - 5.0


def test_sharded_decode_matches_single(system):
    task, graph, lls = system
    tg = tk.build_token_graph(graph)
    mesh = make_mesh(MeshConfig(data=2, model=4))
    kcap = graph.num_states
    run = make_sharded_decode(mesh, tg, kcap=kcap)
    T_max = max(len(l) for l in lls)
    U = 2  # data shards
    batch = np.full((U, T_max, lls[0].shape[1]), 0.0, np.float32)
    lens = np.zeros(U, np.int32)
    for i in range(U):
        ll = lls[i % len(lls)]
        batch[i, : len(ll)] = ll
        lens[i] = len(ll)
    olabs_sh, scores_sh = run(batch, lens)
    for i in range(U):
        ll = lls[i % len(lls)]
        olabs_1, score_1 = tk.decode(tg, ll, kcap=kcap)
        hyp_sh = wd.words_from_olabels(np.asarray(olabs_sh[i])[: lens[i]], task.words)
        hyp_1 = wd.words_from_olabels(np.asarray(olabs_1), task.words)
        assert hyp_sh == hyp_1
        assert abs(float(scores_sh[i]) - float(score_1)) < 1e-2


@pytest.mark.parametrize("n_model", [2, 4])
def test_multishard_kernel_sim_matches_single(system, n_model):
    """The graph-sharded decoder at n_model >= 2 with a binding beam and a
    kcap below the state count: per-shard candidate sets crossing the
    cross-shard merge must equal the single-device decode."""
    from jax.sharding import Mesh

    task, graph, lls = system
    tg = tk.build_token_graph(graph)
    ll = lls[0][:60]
    ol1, sc1 = tk.decode(tg, np.asarray(ll), kcap=128, beam=40.0)
    hyp1 = wd.words_from_olabels(np.asarray(ol1), task.words)
    mesh = Mesh(np.array(jax.devices()[:n_model]).reshape(1, n_model),
                ("data", "model"))
    run = make_sharded_decode(mesh, tg, kcap=128, beam=40.0)
    olabs, scores = run(ll[None], np.asarray([len(ll)], np.int32))
    assert wd.words_from_olabels(np.asarray(olabs[0]), task.words) == hyp1
    assert abs(float(scores[0]) - float(sc1)) < 5e-2


def test_bw_estep_psum_matches_full_batch():
    """Data-parallel Baum-Welch: per-shard accumulators + psum over the
    'data' axis == the single-device full-batch accumulator (the data-parallel
    form of the reference's grid-job accumulator-file merge, SURVEY §3.4)."""
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from golden import gmm_hmm as ggh
    from dsr.asr import smallvocab
    from dsr.asr.decoder import viterbi as jvit
    from dsr.asr.train import ml

    rng = np.random.default_rng(11)
    task = smallvocab.SmallVocabTask(gcorpus.VOCAB[:3])
    corpus = gcorpus.make_corpus(8, min_words=1, max_words=2, seed=11)
    feats_list, transcripts = [], []
    for ws, x in corpus:
        ws = [w if w in task.vocab else task.vocab[0] for w in ws]
        feats_list.append(_feats(x))
        transcripts.append(ws)
    state_seqs = [task.align_graph(ws)[0] for ws in transcripts]
    g0 = ggh.init_gmm_from_feats(feats_list, state_seqs, task.num_states, 2, rng)
    params = jgmm.from_golden(g0)
    feats, lengths = trainer.pad_corpus(feats_list)
    ids, A, init, final = trainer.pad_align_graphs(task, transcripts)
    S = task.num_states

    # single-device full batch
    acc_full, _ = trainer._estep_bw(
        params, feats, lengths, jnp.asarray(ids), jnp.asarray(A),
        jnp.asarray(init), jnp.asarray(final), S,
    )

    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    dsh = P("data")

    def shard_estep(feats, lengths, ids, logA, init, final):
        ll = jgmm.loglik(params, feats)
        ll_graph = jnp.take_along_axis(ll, ids[:, None, :], axis=2)
        gamma_l, _ = jax.vmap(jvit.forward_backward)(ll_graph, logA, init, final, lengths)
        onehot = jax.nn.one_hot(ids, S, dtype=jnp.float32)
        gamma = jnp.einsum("utl,uls->uts", gamma_l, onehot)
        acc = ml.zero_accum(S, params.means.shape[1], params.means.shape[2])
        acc = ml.accumulate(params, feats, gamma, acc)
        return ml.psum_accum(acc, "data")  # the cross-job merge

    run = shard_map(
        shard_estep, mesh=mesh,
        in_specs=(dsh, dsh, dsh, dsh, dsh, dsh),
        out_specs=P(),  # replicated after psum
    )
    with mesh:
        acc_dp = jax.jit(run)(
            jnp.asarray(feats), jnp.asarray(lengths), jnp.asarray(ids),
            jnp.asarray(A), jnp.asarray(init), jnp.asarray(final),
        )
    # f32 reduction-order noise between the sharded psum and the full batch
    for a, b in zip(acc_full, acc_dp):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-2)


def test_sharded_decode_kernel_path_matches_single():
    """The graph-sharded decoder on a data x model mesh, with ragged
    lengths and a binding beam, equals the single-device decode."""
    from dsr.asr.fsm.packed import PackedGraph

    rng = np.random.default_rng(13)
    S, A, P = 256, 4, 10
    src = np.repeat(np.arange(S, dtype=np.int32), A)
    g = PackedGraph(
        src, rng.integers(0, P, S * A).astype(np.int32),
        rng.integers(0, 5, S * A).astype(np.int32),
        np.abs(rng.standard_normal(S * A)).astype(np.float32),
        rng.integers(0, S, S * A).astype(np.int32),
        0, np.where(rng.random(S) < 0.1, 0.0, np.inf).astype(np.float32), S)
    tg = tk.build_token_graph(g)
    mesh = make_mesh(MeshConfig(data=2, model=4))
    for beam in (6.0,):
        run = make_sharded_decode(mesh, tg, kcap=128, beam=beam)
        U, T = 2, 8
        lls = rng.standard_normal((U, T, P)).astype(np.float32) * 3
        lens = np.asarray([T, T - 7], np.int32)
        olabs_sh, scores_sh = run(lls, lens)
        for i in range(U):
            ol1, sc1 = tk.decode(tg, lls[i], kcap=128, beam=beam,
                                 length=int(lens[i]))
            assert abs(float(scores_sh[i]) - float(sc1)) < 1e-3
            assert ([int(o) for o in np.asarray(olabs_sh[i])[: lens[i]] if o]
                    == [int(o) for o in np.asarray(ol1)[: lens[i]] if o])
