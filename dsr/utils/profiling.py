"""Tracing/profiling (SURVEY.md §5): jax.profiler traces with named scopes
per pipeline stage, and audio-sec/s counters (metrics.RtfMeter)."""

from __future__ import annotations

import contextlib
import glob
import os
import re

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def scope(name: str):
    """Named scope for pipeline stages (shows up in traces)."""
    return jax.profiler.TraceAnnotation(name)


def annotate_fn(name: str):
    """Decorator: wrap a function in a named trace scope."""

    def deco(fn):
        def wrapper(*a, **k):
            with scope(name):
                return fn(*a, **k)

        return wrapper

    return deco


# Layer scopes the front end and the decoders open with jax.named_scope;
# `layer_times` attributes device time to them.
LAYERS = ("filterbank_analysis", "beamform_apply", "synthesis", "mfcc",
          "gmm_loglik", "arc_gather", "acoustic_lookup", "recombine_topk",
          "traceback")

# control-flow ops whose events span their bodies' ops (XLA:CPU traces)
_CONTAINERS = re.compile(r"^(while|conditional|call)(\.\d+)?$")
# an op that runs as several kernels names them <op>__<n> (GPU sorts)
_PART = re.compile(r"__\d+$")
_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"',
                    re.M)


def op_layers(hlo_text: str, layers=LAYERS) -> dict[str, str]:
    """Compiled-HLO instruction name → the innermost of `layers` in its
    op_name metadata (instructions outside every layer are left out).
    Names are keyed with '.' as '_', the form GPU kernel names take."""
    out = {}
    for name, op_name in _INSTR.findall(hlo_text):
        hit = [p for p in op_name.split("/") if p in layers]
        if hit:
            out[name.replace(".", "_")] = hit[-1]
    return out


def _newest_trace(trace_dir: str):
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no profiler trace under {trace_dir}")
    return ProfileData.from_file(paths[-1])


def device_busy(trace_dir: str) -> float:
    """Seconds in which at least one op ran on a device (the union of the
    device events' intervals) in the newest trace under `trace_dir`."""
    spans = sorted(
        (ev.start_ns, ev.start_ns + ev.duration_ns)
        for plane in _newest_trace(trace_dir).planes
        if plane.name.startswith("/device:")
        for line in plane.lines for ev in line.events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-9


def op_times(trace_dir: str) -> dict[str, float]:
    """Op name → summed device seconds over the newest profiler trace under
    `trace_dir`.  An event is named by its `hlo_op` stat, or by the kernel
    name when the op ran inside a command buffer (a CUDA graph, which is
    how XLA runs loop bodies on the GPU); events with neither count under
    "".  Device planes are read when the trace has any, else the host
    planes (XLA:CPU runs ops on host threads)."""
    pd = _newest_trace(trace_dir)
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    host = not planes
    if host:
        planes = [p for p in pd.planes if p.name.startswith("/host:CPU")]
    out: dict[str, float] = {}
    for plane in planes:
        for line in plane.lines:
            for ev in line.events:
                op = str(dict(ev.stats).get("hlo_op", ""))
                if _CONTAINERS.match(op) or (host and not op):
                    continue
                if op in ("", "command_buffer"):
                    op = _PART.sub("", ev.name)
                op = op.replace(".", "_")
                out[op] = out.get(op, 0.0) + ev.duration_ns * 1e-9
    return out


def layer_times(trace_dir: str, hlo_texts: dict[str, str],
                layers=LAYERS) -> dict[str, float]:
    """Seconds of device time per layer in a traced window.

    hlo_texts: compiled HLO text of every jitted program that ran in the
    window (``jitted.lower(...).compile().as_text()``), keyed by anything.
    Ops outside every layer are summed under "other"; "total" is all ops."""
    names: dict[str, str] = {}
    for text in hlo_texts.values():
        names.update(op_layers(text, layers))
    out = {k: 0.0 for k in (*layers, "other", "total")}
    for op, sec in op_times(trace_dir).items():
        out[names.get(op, "other")] += sec
        out["total"] += sec
    return out
