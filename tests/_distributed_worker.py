"""Worker for the 2-process `jax.distributed` drill
(tests/test_distributed_multiprocess.py).  Run standalone:

    python tests/_distributed_worker.py <port> <process_id> <outdir> [mode]

Each of the 2 processes hosts 2 virtual CPU devices (global mesh = 4).
The worker initialises the distributed runtime through
`dsr.parallel.mesh.initialize_distributed` (SURVEY.md §2.3 comm
backend), then:

  - runs a shard_map psum over the global `data` axis (a cross-PROCESS
    collective: each process holds half the shards);
  - runs a jit global sum with replicated out-sharding (implicit
    all-reduce);
  - saves a process-sharded checkpoint (each process writes only its
    addressable shards) and restores it, asserting bit-identity;
  - writes a JSON result file the parent asserts on.

mode="hang" (process 1 only): after init, the worker sleeps through its
collective instead of participating — the drill asserts process 0's
collective FAILS within the coordination-service heartbeat timeout rather
than hanging forever (SURVEY.md §5 failure detection).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    port, pid, outdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mode = sys.argv[4] if len(sys.argv) > 4 else "run"

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    )

    import numpy as np
    import jax

    from dsr.parallel.mesh import initialize_distributed

    # the real multi-process path this drill exists to execute
    initialize_distributed(f"localhost:{port}", 2, pid,
                           heartbeat_timeout_s=20)

    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from dsr.utils import checkpoint as ckpt

    result = {"pid": pid, "process_index": jax.process_index(),
              "num_processes": jax.process_count(),
              "local_devices": len(jax.local_devices()),
              "global_devices": len(jax.devices())}
    assert jax.process_index() == pid
    assert len(jax.devices()) == 4, jax.devices()

    mesh = Mesh(np.array(jax.devices()).reshape(4), ("data",))
    sharding = NamedSharding(mesh, P("data"))
    # each process supplies ONLY its local shards of the global (8,) array
    x = jax.make_array_from_callback(
        (8,), sharding,
        lambda idx: np.arange(8, dtype=np.float32)[idx])

    if mode == "hang":
        # skip the collective: the peer's psum must fail on heartbeat
        # timeout, not hang.  Sleep longer than the parent's kill window.
        time.sleep(120)
        return

    # cross-process collective 1: explicit shard_map psum over `data`
    f = jax.jit(shard_map(
        lambda a: jax.lax.psum(jnp.sum(a), "data"),
        mesh=mesh, in_specs=P("data"), out_specs=P()))
    total = f(x)
    result["psum"] = float(total)

    # cross-process collective 2: implicit all-reduce via replicated output
    g = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))
    result["jit_sum"] = float(g(x))

    # cross-process sharded checkpoint: each process writes only its own
    # shards; restore reassembles onto the same layout
    ckdir = os.path.join(outdir, "ckpt")
    tree = {"w": x, "step": jnp.asarray(3.0)}
    ckpt.save_sharded(ckdir, tree)
    # both processes must finish writing before either restores
    done = os.path.join(outdir, f"saved.{pid}")
    open(done, "w").close()
    other = os.path.join(outdir, f"saved.{1 - pid}")
    deadline = time.time() + 60
    while not os.path.exists(other):
        if time.time() > deadline:
            raise TimeoutError("peer never finished checkpoint save")
        time.sleep(0.05)
    restored = ckpt.restore_sharded(ckdir, tree)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(
            restored["w"])),
        np.arange(8, dtype=np.float32))
    result["restore_ok"] = True

    with open(os.path.join(outdir, f"result.{pid}.json"), "w") as fh:
        json.dump(result, fh)


if __name__ == "__main__":
    main()
