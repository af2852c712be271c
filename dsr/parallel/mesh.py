"""Device-mesh construction for the (data, model, subband) logical axes."""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

from dsr.config import MeshConfig

AXES = ("data", "model", "subband")


def make_mesh(cfg: MeshConfig | None = None, devices=None) -> Mesh:
    """Build a Mesh over the logical axes.

    With cfg=None, all devices go to `data` (utterance-batch parallelism,
    the dominant axis for DSR workloads).  Axis sizes must multiply to the
    device count used.
    """
    devices = jax.devices() if devices is None else devices
    if cfg is None:
        cfg = MeshConfig(data=len(devices))
    n = cfg.num_devices
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.asarray(devices[:n]).reshape(cfg.data, cfg.model, cfg.subband)
    return Mesh(arr, AXES)


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None,
                           heartbeat_timeout_s: float | None = None) -> None:
    """Multi-host runtime init (jax.distributed) — the reference's grid-job
    scale-out story becomes a real communication backend (SURVEY.md §2.3).

    Liveness: jax.distributed's coordination service heartbeats every
    process; `heartbeat_timeout_s` bounds how long a dead host can stall a
    collective before the step fails.  The failure unit is then the WORK
    ITEM — `utils/heartbeat.LeaseBoard` + `run_recoverable` make a dead
    worker's batches re-claimable by survivors (SURVEY.md §5 failure
    detection / elastic recovery; tests/test_failure_recovery.py drills a
    mid-batch SIGKILL).

    No-op when single-process (the only mode testable in this environment).
    """
    if num_processes and num_processes > 1:
        kw = {}
        if heartbeat_timeout_s is not None:
            kw["heartbeat_timeout_seconds"] = int(heartbeat_timeout_s)
        jax.distributed.initialize(coordinator, num_processes, process_id, **kw)
