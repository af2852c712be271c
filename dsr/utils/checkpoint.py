"""Checkpoint/resume (SURVEY.md §5): sharded checkpoints of model
parameters / beamformer state / trainer accumulators, plus the
decode-progress high-water mark that makes recovery = re-decode the lost
batch (the reference's restart-from-model-files story, made first-class).

Two interchangeable formats:

- orbax `StandardCheckpointer` (primary): per-shard tensorstore writes, no
  host gather, restores WITH the template's sharding (verified on the
  8-device CPU mesh).
- a self-contained per-shard format (`save_sharded`/`restore_sharded`):
  each process writes ONLY its addressable shards as `.npy` files plus an
  `index.<process>.json` recording global shape/dtype and each shard's
  slice bounds; restore assembles device arrays shard-by-shard with
  `jax.make_array_from_single_device_arrays` — the full array never exists
  on the host.  Complex leaves (adaptive-beamformer state) are saved as
  complex .npy shards.

`save`/`restore` try orbax first and fall back to the sharded format.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

_INDEX = "index.{}.json"


def _leaf_paths(tree: Any) -> list[tuple[str, Any]]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(kp), leaf) for kp, leaf in flat]


def save_sharded(path: str, tree: Any) -> None:
    """Write each leaf's ADDRESSABLE shards as .npy + an index file.

    Multi-host: every process calls this; each writes only its own shards
    and its own index file (process-local I/O, no gather, no coordination
    beyond a shared filesystem).
    """
    p = pathlib.Path(os.path.abspath(path))
    p.mkdir(parents=True, exist_ok=True)
    proc = jax.process_index()
    index: dict[str, dict] = {}
    for li, (name, leaf) in enumerate(_leaf_paths(tree)):
        arr = jnp.asarray(leaf)
        shards = []
        for si, sh in enumerate(arr.addressable_shards):
            fn = f"leaf{li}.p{proc}.s{si}.npy"
            np.save(p / fn, np.asarray(sh.data))
            bounds = [
                [0 if s.start is None else int(s.start),
                 int(arr.shape[d]) if s.stop is None else int(s.stop)]
                for d, s in enumerate(sh.index)
            ]
            shards.append({"file": fn, "bounds": bounds})
        index[name] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                       "shards": shards}
    with open(p / _INDEX.format(proc), "w") as f:
        json.dump(index, f)


def restore_sharded(path: str, template: Any) -> Any:
    """Restore into `template`'s shardings, shard by shard.

    `template` leaves are jax.Arrays (or anything with .shape/.dtype/
    .sharding).  Each target device's required slice is looked up in the
    index by its bounds and device_put directly — the global array is
    never materialised on the host.
    """
    p = pathlib.Path(os.path.abspath(path))
    index: dict[str, dict] = {}
    for f in sorted(p.glob(_INDEX.format("*"))):
        # merge per-leaf across per-PROCESS index files: each process
        # records only its own shards, so shard lists concatenate (a plain
        # dict.update would keep only the last process's shards — caught
        # by the 2-process drill in tests/test_distributed_multiprocess.py)
        for name, entry in json.loads(f.read_text()).items():
            if name not in index:
                index[name] = entry
                continue
            have = index[name]
            if (entry["shape"] != have["shape"]
                    or entry["dtype"] != have["dtype"]):
                raise ValueError(
                    f"{name}: inconsistent shape/dtype across process index "
                    "files")
            have["shards"].extend(entry["shards"])

    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for kp, leaf in flat:
        name = jax.tree_util.keystr(kp)
        entry = index[name]
        shape = tuple(entry["shape"])
        by_bounds = {
            tuple(tuple(b) for b in s["bounds"]): s["file"]
            for s in entry["shards"]
        }
        dev_map = leaf.sharding.addressable_devices_indices_map(shape)
        arrs = []
        for dev, idx in dev_map.items():
            bounds = tuple(
                (0 if s.start is None else int(s.start),
                 shape[d] if s.stop is None else int(s.stop))
                for d, s in enumerate(idx)
            )
            fn = by_bounds.get(bounds)
            if fn is None:
                raise ValueError(
                    f"{name}: no saved shard with bounds {bounds} "
                    "(restoring onto a different sharding layout?)"
                )
            arrs.append(jax.device_put(np.load(p / fn), dev))
        out.append(jax.make_array_from_single_device_arrays(
            shape, leaf.sharding, arrs))
    return jax.tree_util.tree_unflatten(treedef, out)


def save(path: str, tree: Any) -> None:
    """Save a pytree checkpoint (orbax primary, per-shard format fallback)."""
    path = os.path.abspath(path)
    try:
        import orbax.checkpoint as ocp

        ckptr = ocp.StandardCheckpointer()
        ckptr.save(path, tree, force=True)
        ckptr.wait_until_finished()
        return
    except Exception as e:
        import warnings

        warnings.warn(f"orbax save failed ({e!r}); using the per-shard format")
    save_sharded(path, tree)


def restore(path: str, template: Any) -> Any:
    """Restore a pytree checkpoint into `template`'s structure+shardings."""
    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, _INDEX.format(jax.process_index()))):
        return restore_sharded(path, template)
    legacy = os.path.join(path, "ckpt.npz")
    if os.path.exists(legacy):  # pre-sharded-format checkpoints
        z = np.load(legacy)
        leaves = [z[k] for k in z.files]
        return jax.tree.unflatten(jax.tree.structure(template), leaves)
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(path, template)


class DecodeProgress:
    """Utterance-index high-water mark for restartable batch decoding."""

    def __init__(self, path: str):
        self.path = path
        self.done: set[str] = set()
        if os.path.exists(path):
            with open(path) as f:
                self.done = set(json.load(f))

    def is_done(self, utt_id: str) -> bool:
        return utt_id in self.done

    def mark(self, utt_id: str) -> None:
        self.done.add(utt_id)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(sorted(self.done), f)
        os.replace(tmp, self.path)
