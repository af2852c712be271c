"""Synthetic LVCSR task — BASELINE.json config 4 ("large-vocab HCLG,
graph sharded when it exceeds one chip"; SURVEY.md §2.2/§2.3).

The reference's LVCSR recipes read an external pronunciation lexicon and an
ARPA n-gram LM (SURVEY.md §2.2 dict/lm rows [K]); this environment ships no
corpus, so the task is *generated*: random pronunciations over a CMU-style
phone inventory, a sparse-Markov text corpus, an absolute-discount trigram
ARPA (`lm.train_arpa_ngram`), and HCLG composed entirely through the native
C++ handle pipeline (`fsm/native.NativeFst`) — the intermediate graphs
(L∘G, det, H∘LG, rmeps) never round-trip through Python objects.

Graph-shape property that makes the result decodable with fixed-width
token tables: the lexicon uses
late word labels (`build_lexicon_fst(olabel_at="end")`), so pair-encoded
determinization shares pronunciation prefixes across words and every
state's out-degree is bounded by the phone inventory, not the vocabulary —
the packed (S, A_max) token tables stay narrow at 10^5–10^6 arcs.

Graphs are cached (npz) under `.cache/lvcsr` in the checkout (or
$DSR_CACHE) keyed by the build params.
"""

from __future__ import annotations

import hashlib
import json
import os
import pathlib
import time
from dataclasses import dataclass

import numpy as np

from dsr.asr.fsm import lm as _lm
from dsr.asr.fsm import native as _native
from dsr.asr.fsm.hclg import (
    SymbolTable, build_hmm_fst, build_lexicon_fst, build_lg_fst,
)
from dsr.asr.fsm.packed import PackedGraph, pack_csr

# CMU-style condensed phone inventory (39 phones + sil)
PHONE_INVENTORY = (
    "aa ae ah ao aw ay b ch d dh eh er ey f g hh ih iy jh k l m n ng ow oy "
    "p r s sh t th uh uw v w y z zh"
).split()


def make_lexicon(
    vocab_size: int, rng: np.random.Generator, min_len: int = 2, max_len: int = 7
) -> dict[str, tuple[str, ...]]:
    """Random pronunciations; natural collisions become homophones (legal —
    the late-label lexicon keeps them distinct by olabel)."""
    lex = {}
    for i in range(vocab_size):
        n = int(rng.integers(min_len, max_len + 1))
        pron = tuple(PHONE_INVENTORY[int(j)] for j in rng.integers(0, len(PHONE_INVENTORY), n))
        lex[f"w{i:05d}"] = pron
    return lex


def make_text(
    vocab: list[str],
    n_tokens: int,
    branching: int,
    rng: np.random.Generator,
    min_sent: int = 6,
    max_sent: int = 14,
) -> list[list[str]]:
    """Sparse-Markov sentences: each word has `branching` possible
    successors, so n-gram type counts (→ G/HCLG size) are controlled by
    (vocab, branching, n_tokens) instead of exploding combinatorially."""
    V = len(vocab)
    succ = rng.integers(0, V, size=(V, branching))
    sents, count = [], 0
    while count < n_tokens:
        n = int(rng.integers(min_sent, max_sent + 1))
        w = int(rng.integers(0, V))
        sent = [vocab[w]]
        for _ in range(n - 1):
            w = int(succ[w, int(rng.integers(0, branching))])
            sent.append(vocab[w])
        sents.append(sent)
        count += n
    return sents


@dataclass(frozen=True)
class LvcsrConfig:
    vocab_size: int = 2000
    n_tokens: int = 30_000
    branching: int = 4
    order: int = 3
    states_per_phone: int = 3
    seed: int = 0

    def key(self) -> str:
        # _fmt bumps invalidate cached graphs when the BUILD pipeline
        # changes (v2: compose joint eps:eps filter move fix)
        blob = json.dumps({**self.__dict__, "_fmt": 2}, sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:12]


@dataclass
class LvcsrTask:
    graph: PackedGraph
    words: SymbolTable
    phones: SymbolTable
    lexicon: dict[str, tuple[str, ...]]
    cfg: LvcsrConfig
    build_stats: dict

    @property
    def num_pdfs(self) -> int:
        return (len(self.phones) - 1) * self.cfg.states_per_phone


# CMU-class questions for triphone state tying at LVCSR scale
TRI_QUESTIONS = {
    "vowel": set("aa ae ah ao aw ay eh er ey ih iy ow oy uh uw".split()),
    "front_v": set("iy ih eh ey ae".split()),
    "back_v": set("uw uh ow ao aa".split()),
    "stop": set("p b t d k g".split()),
    "fric": set("f v th dh s z sh zh hh".split()),
    "affric": set("ch jh".split()),
    "nasal": set("m n ng".split()),
    "liquid": set("l r w y".split()),
    "sil": {"sil"},
}


def _tri_feat_dim(phones, spp: int) -> int:
    return (len(phones) - 1) * spp + len(TRI_QUESTIONS)


def _tri_mean(phones, spp: int, l_name: str, c_pid: int, pos: int,
              scale: float = 4.0) -> np.ndarray:
    """Analytic feature mean for (left-context, center-state): the center
    (c, pos) one-hot plus left-context coloring on the question dims —
    context-dependent structure the tree can genuinely tie on."""
    D = _tri_feat_dim(phones, spp)
    m = np.zeros(D, np.float32)
    m[(c_pid - 1) * spp + pos] = scale
    base = (len(phones) - 1) * spp
    for j, cls in enumerate(TRI_QUESTIONS.values()):
        if l_name in cls:
            m[base + j] = 0.5 * scale
    return m


def synthetic_am(task: "LvcsrTask", scale: float = 4.0, var: float = 0.25):
    """A well-separated diagonal GMM over D = num_pdfs feature dims (mean of
    pdf p = scale·e_p): lets WER gates exercise the FULL lexicon/LM/HMM
    semantics of the big graph with near-noiseless acoustics.  Pass
    var = noise² to match `synthesize_utterance`'s noise level (a
    well-calibrated AM — the WER-vs-pruning study needs the
    acoustic/LM balance realistic, not variance-mis-specified)."""
    from dsr.asr.am.gmm import GmmParams
    import jax.numpy as jnp

    P = task.num_pdfs
    means = (scale * np.eye(P, dtype=np.float32))[:, None, :]
    var = np.full((P, 1, P), var, np.float32)
    logw = np.zeros((P, 1), np.float32)
    return GmmParams(jnp.asarray(means), jnp.asarray(var), jnp.asarray(logw))


def synthesize_utterance(task: "LvcsrTask", sentence: list[str],
                         rng: np.random.Generator, scale: float = 4.0,
                         noise: float = 0.5, sil_prob: float = 0.5,
                         dur: tuple[int, int] = (2, 5)) -> np.ndarray:
    """Render `sentence` to (T, num_pdfs) features matching `synthetic_am`:
    each word's pronunciation expands to its HMM pdf sequence (the
    build_hmm_fst convention pdf = (phone−1)·spp + k), with random state
    durations and optional post-word silence (the build_lg_fst topology)."""
    spp = task.cfg.states_per_phone
    pdfs: list[int] = []

    def emit_phone(name: str):
        pid = task.phones[name]
        for k in range(spp):
            pdfs.extend([(pid - 1) * spp + k] * int(rng.integers(*dur)))

    for w in sentence:
        for ph in task.lexicon[w]:
            emit_phone(ph)
        if rng.random() < sil_prob:
            emit_phone("sil")
    T = len(pdfs)
    feats = noise * rng.standard_normal((T, task.num_pdfs)).astype(np.float32)
    feats[np.arange(T), pdfs] += scale
    return feats


@dataclass
class LvcsrTriTask:
    """Triphone LVCSR task: tied-state triphone HCLG (H_tri ∘ C ∘ det(LG))
    built through the native core, with the analytic tied-state AM."""

    graph: PackedGraph
    words: SymbolTable
    phones: SymbolTable
    lexicon: dict[str, tuple[str, ...]]
    cfg: LvcsrConfig
    tree: object               # asr.tree.DistribTree
    num_pdfs: int
    am_means: np.ndarray       # (num_pdfs, D) analytic leaf means
    build_stats: dict


def build_task_tri(cfg: LvcsrConfig = LvcsrConfig(vocab_size=300,
                                                  n_tokens=5000, branching=3),
                   verbose: bool = False) -> LvcsrTriTask:
    """Triphone config-4 build: trigram G → det(LG) → C (delayed-emission
    context transducer) → likelihood-gain tied tree → H_tri — every
    at-scale composition through the native WFST core.  Tree statistics
    are analytic (`_tri_mean`): contexts colored by their left phone's
    question classes, so the tying is non-trivial and exactly learnable.
    """
    from dsr.asr import tree as ptree
    from dsr.asr import triphone

    rng = np.random.default_rng(cfg.seed)
    lex = make_lexicon(cfg.vocab_size, rng)
    vocab = sorted(lex)
    words = SymbolTable(vocab + ["</s>", "<s>"])
    phones = SymbolTable(PHONE_INVENTORY + ["sil"])
    spp = cfg.states_per_phone
    if not _native.available():
        raise RuntimeError("triphone LVCSR build needs the native WFST core")

    t0 = time.time()
    text = make_text(vocab, cfg.n_tokens, cfg.branching, rng)
    arpa = _lm.train_arpa_ngram(text, vocab, order=cfg.order)
    G = _lm.arpa_to_fst(arpa, words)
    nCLGr, tbl, seen = triphone.build_clg_native(lex, phones, words, G)
    t1 = time.time()

    stats: dict = {}
    n0 = 200.0
    for sym in seen:
        l, c, r = tbl.untri(sym)
        ln, cn, rn = phones.name(l), phones.name(c), phones.name(r)
        for pos in range(spp):
            m = _tri_mean(phones, spp, ln, c, pos).astype(np.float64)
            stats[(ln, cn, rn, pos)] = [n0, n0 * m, n0 * (0.25 + m * m)]
    tree = ptree.build_tree(stats, questions=TRI_QUESTIONS, min_gain=50.0,
                            min_count=10.0, max_leaves=4000)
    graph, gstats = triphone.finish_tri_hclg_native(nCLGr, tbl, tree, phones,
                                                    spp, seen_tris=seen)
    bstats = {
        **gstats, "seen_triphones": len(seen),
        "build_fsts_s": round(t1 - t0, 2),
        "build_tri_s": round(time.time() - t1, 2),
    }
    # analytic tied-state AM: leaf mean = count-weighted mean of its contexts
    D = _tri_feat_dim(phones, spp)
    P_leaves = tree.num_leaves
    sums = np.zeros((P_leaves, D))
    cnts = np.zeros(P_leaves)
    for (ln, cn, rn, pos), (n_, sx, _) in stats.items():
        leaf = tree.lookup(ln, cn, rn, pos)
        sums[leaf] += sx
        cnts[leaf] += n_
    am_means = (sums / np.maximum(cnts[:, None], 1.0)).astype(np.float32)
    if verbose:
        print(f"LVCSR tri HCLG: {bstats}")
    return LvcsrTriTask(graph, words, phones, lex, cfg, tree,
                        P_leaves, am_means, bstats)


def synthetic_am_tri(task: LvcsrTriTask, var: float = 0.25):
    """Diagonal GMM over the tied leaves (means = analytic leaf means)."""
    from dsr.asr.am.gmm import GmmParams
    import jax.numpy as jnp

    P, D = task.am_means.shape
    return GmmParams(
        jnp.asarray(task.am_means[:, None, :]),
        jnp.full((P, 1, D), var, jnp.float32),
        jnp.zeros((P, 1), jnp.float32),
    )


def synthesize_utterance_tri(task: LvcsrTriTask, sentence: list[str],
                             rng: np.random.Generator, noise: float = 0.5,
                             sil_prob: float = 0.5,
                             dur: tuple[int, int] = (2, 5)) -> np.ndarray:
    """Render `sentence` with CONTEXT-DEPENDENT acoustics: frame means are
    the analytic (left-context, center-state) means `_tri_mean`, matching
    the C transducer's sil-boundary conventions."""
    spp = task.cfg.states_per_phone
    seq: list[str] = []
    for wd in sentence:
        seq.extend(task.lexicon[wd])
        if rng.random() < sil_prob:
            seq.append("sil")
    rows = []
    for i, ph in enumerate(seq):
        ln = seq[i - 1] if i > 0 else "sil"
        pid = task.phones[ph]
        for pos in range(spp):
            m = _tri_mean(task.phones, spp, ln, pid, pos)
            rows.extend([m] * int(rng.integers(*dur)))
    feats = np.stack(rows)
    return (feats + noise * rng.standard_normal(feats.shape)).astype(np.float32)


def _cache_dir() -> pathlib.Path:
    d = pathlib.Path(os.environ.get("DSR_CACHE") or
                     pathlib.Path(__file__).resolve().parents[2] / ".cache"
                     ) / "lvcsr"
    d.mkdir(parents=True, exist_ok=True)
    return d


def build_task(cfg: LvcsrConfig = LvcsrConfig(), verbose: bool = False) -> LvcsrTask:
    """Generate (or load from cache) the LVCSR task: lexicon + trigram LM +
    packed HCLG.  Requires the native WFST core (LVCSR-scale composition is
    a C++ job by design — SURVEY.md §2.2 fsm row)."""
    rng = np.random.default_rng(cfg.seed)
    lex = make_lexicon(cfg.vocab_size, rng)
    vocab = sorted(lex)
    words = SymbolTable(vocab + ["</s>", "<s>"])
    phones = SymbolTable(PHONE_INVENTORY + ["sil"])

    cache = _cache_dir() / f"lvcsr_{cfg.key()}.npz"
    if cache.exists():
        z = np.load(cache, allow_pickle=False)
        graph = PackedGraph(
            z["src"], z["pdf"], z["olabel"], z["weight"], z["dst"],
            int(z["start"]), z["final_weight"], int(z["num_states"]),
        )
        stats = json.loads(str(z["stats"]))
        return LvcsrTask(graph, words, phones, lex, cfg, stats)

    if not _native.available():
        raise RuntimeError(
            "LVCSR graph build needs the native WFST core (make -C native)"
        )

    t0 = time.time()
    text = make_text(vocab, cfg.n_tokens, cfg.branching, rng)
    arpa = _lm.train_arpa_ngram(text, vocab, order=cfg.order)
    G = _lm.arpa_to_fst(arpa, words)
    LG = build_lg_fst(lex, phones, words, G, sil_phone="sil")
    H = build_hmm_fst(len(phones) - 1, 0, cfg.states_per_phone)
    t1 = time.time()

    nLG = _native.NativeFst.from_wfst(LG)
    nLGd = nLG.determinize()
    nLG.free()
    nH = _native.NativeFst.from_wfst(H)
    nHLG = nH.compose(nLGd)
    nH.free(); nLGd.free()
    nOut = nHLG.rmepsilon()          # ends with connect()
    nHLG.free()
    stats = {
        "num_states": nOut.num_states,
        "num_arcs": nOut.num_arcs,
        "max_outdeg": nOut.max_outdeg,
        "build_fsts_s": round(t1 - t0, 2),
        "build_native_s": round(time.time() - t1, 2),
        "arpa_ngrams": arpa.count("\n"),
    }
    off, il, ol, w, nxt, start, fin = nOut.to_csr()
    nOut.free()
    graph = pack_csr(off, il, ol, w, nxt, start, fin)
    if verbose:
        print(f"LVCSR HCLG: {stats}")
    # atomic publish: concurrent builders / interrupts must never leave a
    # truncated npz that later runs load and crash on
    tmp = cache.with_suffix(f".tmp{os.getpid()}.npz")
    np.savez_compressed(
        tmp,
        src=graph.src, pdf=graph.pdf, olabel=graph.olabel, weight=graph.weight,
        dst=graph.dst, start=np.int64(graph.start),
        final_weight=graph.final_weight, num_states=np.int64(graph.num_states),
        stats=np.str_(json.dumps(stats)),
    )
    os.replace(tmp, cache)
    return LvcsrTask(graph, words, phones, lex, cfg, stats)
