"""Checkpoint/resume, work queue, profiling-scope smoke gates."""

import numpy as np
import pytest

import jax.numpy as jnp

from dsr.asr.am.gmm import GmmParams
from dsr.utils import checkpoint as ckpt
from dsr.utils import profiling
from dsr.utils import workqueue


def test_checkpoint_roundtrip(tmp_path):
    p = GmmParams(
        jnp.arange(24, dtype=jnp.float32).reshape(2, 3, 4),
        jnp.ones((2, 3, 4)),
        jnp.zeros((2, 3)),
    )
    path = str(tmp_path / "ck")
    ckpt.save(path, p)
    q = ckpt.restore(path, p)
    np.testing.assert_allclose(np.asarray(q.means), np.asarray(p.means))
    np.testing.assert_allclose(np.asarray(q.variances), np.asarray(p.variances))


def test_decode_progress_and_workqueue_resume(tmp_path):
    path = str(tmp_path / "progress.json")
    utts = [f"utt{i:03d}" for i in range(10)]
    seen = []

    def crashy(batch):
        if "utt006" in batch:
            raise RuntimeError("simulated failure")
        seen.extend(batch)

    prog = ckpt.DecodeProgress(path)
    with pytest.raises(RuntimeError):
        workqueue.run_batched(utts, 2, crashy, prog)
    # resume: completed utterances are skipped, the failed batch is retried
    prog2 = ckpt.DecodeProgress(path)
    done_before = set(prog2.done)
    assert "utt006" not in done_before and "utt000" in done_before
    seen2 = []
    workqueue.run_batched(utts, 2, lambda b: seen2.extend(b), prog2)
    assert set(seen2) == set(utts) - done_before
    prog3 = ckpt.DecodeProgress(path)
    assert prog3.done == set(utts)


def test_profiling_scope_smoke():
    with profiling.scope("stage"):
        x = jnp.sum(jnp.ones(8))
    assert float(x) == 8.0


def test_op_layers_maps_instructions_to_innermost_scope():
    hlo = (
        '  %fusion.3 = f32[8]{0} fusion(%p), kind=kLoop, metadata={op_name='
        '"jit(f)/while/body/arc_gather/recombine_topk/sort"}\n'
        '  ROOT %copy.2 = f32[8]{0} copy(%fusion.3), metadata={op_name='
        '"jit(f)/traceback/copy"}\n'
        '  %add.1 = f32[8]{0} add(%a, %b), metadata={op_name="jit(f)/add"}\n')
    assert profiling.op_layers(hlo) == {"fusion_3": "recombine_topk",
                                        "copy_2": "traceback"}


def test_layer_times_from_a_recorded_trace(tmp_path):
    """A decode traced on the host attributes its ops to the decoder's
    layer scopes, and the layers plus "other" add up to the total."""
    import jax
    import jax.numpy as jnp
    from dsr.asr.decoder import topk_decoder as tk
    from dsr.asr.fsm.packed import PackedGraph

    rng = np.random.default_rng(0)
    S, A, P = 64, 4, 6
    g = PackedGraph(np.repeat(np.arange(S, dtype=np.int32), A),
                    rng.integers(0, P, S * A).astype(np.int32),
                    rng.integers(0, 3, S * A).astype(np.int32),
                    rng.random(S * A).astype(np.float32),
                    rng.integers(0, S, S * A).astype(np.int32), 0,
                    np.zeros(S, np.float32), S)
    tg = tk.build_token_graph(g)
    args = (jnp.asarray(rng.standard_normal((20, P)).astype(np.float32)),
            jnp.int32(20), tg.pdf, tg.olabel, tg.weight, tg.dst, tg.start,
            tg.final_weight)
    kw = dict(a_max=tg.a_max, kcap=32, beam=1e9)
    text = tk._decode_impl.lower(*args, **kw).compile().as_text()
    jax.block_until_ready(tk._decode_impl(*args, **kw))
    with profiling.trace(str(tmp_path)):
        jax.block_until_ready(tk._decode_impl(*args, **kw))
    t = profiling.layer_times(str(tmp_path), {"decode": text})
    assert t["recombine_topk"] > 0 and t["total"] > 0
    parts = sum(v for k, v in t.items() if k != "total")
    assert abs(parts - t["total"]) < 1e-9
