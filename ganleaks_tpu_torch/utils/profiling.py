"""Tracing and profiling (port of ``ganleaks_tpu.utils.profiling``):
stage annotations with cumulative throughput meters, a profiler trace of
a block of work, anomaly detection and a non-finite output guard.

Differences from the JAX package, on purpose:

* :func:`trace_stage` synchronises a CUDA device at entry and at exit, so
  its seconds measure the stage's execution on the card, not how long the
  host took to queue it (the JAX version times dispatch unless the caller
  blocks on the outputs inside the stage);
* :func:`profile_to` writes a Chrome trace (``torch.profiler``), not an
  XProf directory, and refuses a run on a CUDA device that recorded no
  device activity: a trace of the host alone would hide the card;
* :func:`checked` guards floating outputs only (the float half of
  ``checkify``): an out-of-range index is torch's own error, ``IndexError``
  on the CPU and a device-side assert on CUDA.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch


def _device(device) -> torch.device:
    """``device``, or where queued work may sit when it is None: the
    current CUDA device once this process has initialised CUDA, else the
    CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_initialized() else "cpu")


@contextlib.contextmanager
def trace_stage(name: str, meters: dict | None = None,
                items: int | None = None, device=None):
    """Annotate a pipeline stage for the profiler (``record_function``,
    and an NVTX range on a CUDA device) and add its seconds (and
    ``items``) to ``meters``: ``{name}_seconds`` and ``{name}_items``
    accumulate across entries, so ``{name}_items_per_sec`` is the
    cumulative rate. On a CUDA device (``device``, module docstring) the
    stage synchronises at entry and at exit: the seconds are the card's
    execution of the stage's work."""
    cuda = _device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.nvtx.range_push(name)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
            if cuda:
                torch.cuda.synchronize()
    finally:
        if cuda:
            torch.cuda.nvtx.range_pop()
    dt = time.perf_counter() - t0
    if meters is not None:
        secs = meters.get(f"{name}_seconds", 0.0) + dt
        meters[f"{name}_seconds"] = secs
        if items is not None:
            total = meters.get(f"{name}_items", 0) + items
            meters[f"{name}_items"] = total
            meters[f"{name}_items_per_sec"] = (total / secs if secs > 0
                                               else 0.0)


@dataclass
class ProfileRun:
    """What :func:`profile_to` recorded: the Chrome trace's path and the
    profiler's events (``torch.profiler`` ``FunctionEvent`` s, CPU and
    device, on one clock in microseconds)."""

    trace_path: str | None = None
    events: list = field(default_factory=list)


@contextlib.contextmanager
def profile_to(log_dir: str | None, device=None):
    """Profile the body (CPU activity, and CUDA activity on a CUDA
    ``device``) and write a Chrome trace under ``log_dir``; yields a
    :class:`ProfileRun` that is filled when the body ends. ``log_dir``
    None profiles nothing and yields None. Raises ``RuntimeError`` when a
    run on a CUDA device recorded no device activity."""
    if not log_dir:
        yield None
        return
    cuda = _device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    run = ProfileRun()
    with torch.profiler.profile(activities=acts) as prof:
        yield run
        if cuda:
            torch.cuda.synchronize()
    fd, run.trace_path = tempfile.mkstemp(prefix="trace-", suffix=".json",
                                          dir=log_dir)
    os.close(fd)
    prof.export_chrome_trace(run.trace_path)
    run.events = list(prof.events())
    if cuda and not device_activity(run.events):
        raise RuntimeError(
            f"the profiler recorded no CUDA activity on {device or 'cuda'} "
            f"(trace {run.trace_path}): CUPTI is not tracing this card")


def device_activity(events) -> list[tuple]:
    """``(name, start_us, end_us)`` of every device activity among
    profiler ``events`` (kernels, copies, sets), in start order; GPU-side
    user annotations are left out."""
    out = []
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CPU
                or getattr(e, "is_user_annotation", False)):
            continue
        out.append((e.name, float(e.time_range.start),
                    float(e.time_range.end)))
    return sorted(out, key=lambda a: a[1])


def kernel_table(activity: list[tuple]) -> list[dict]:
    """Device time and launches per name, by total time (largest
    first)."""
    table: dict[str, dict] = {}
    for name, start, end in activity:
        row = table.setdefault(name, {"name": name, "launches": 0,
                                      "total_ms": 0.0})
        row["launches"] += 1
        row["total_ms"] += (end - start) / 1e3
    return sorted(table.values(), key=lambda r: -r["total_ms"])


def idle_share(activity: list[tuple], start_us: float,
               end_us: float) -> float:
    """Share of the window [``start_us``, ``end_us``] in which no device
    activity ran (the union of the intervals, clipped to the window)."""
    busy, cursor = 0.0, start_us
    for _name, s, e in activity:
        s, e = max(s, cursor), min(e, end_us)
        if e > s:
            busy += e - s
            cursor = e
    span = end_us - start_us
    return 1.0 - busy / span if span > 0 else 0.0


def stage_window(events, name: str) -> tuple[float, float]:
    """``(start_us, end_us)`` of the last host range named ``name``
    (:func:`trace_stage`'s ``record_function``) among profiler events."""
    spans = [(float(e.time_range.start), float(e.time_range.end))
             for e in events
             if e.name == name
             and e.device_type == torch.autograd.DeviceType.CPU]
    if not spans:
        raise ValueError(f"no host range named {name!r} in the profile")
    return spans[-1]


def call_seconds(fn, device, reps: int = 3) -> float:
    """Seconds per call of ``fn()`` over ``reps`` calls after one
    unmeasured warm-up call: CUDA events around the calls on a CUDA device
    (device time of the queued work, read once), the host clock on the
    CPU."""
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def enable_nan_debugging(enabled: bool = True) -> None:
    """The reference's ``torch.autograd.set_detect_anomaly(True)``
    (``privDCGAN.py:63``): a backward that produces NaN raises, naming the
    forward operation."""
    torch.autograd.set_detect_anomaly(enabled)


def _floats(out, path: str):
    """``(path, array)`` of every floating leaf of ``out``."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() or out.is_complex():
            yield path, out
    elif isinstance(out, np.ndarray):
        if np.issubdtype(out.dtype, np.inexact):
            yield path, out
    elif isinstance(out, (float, np.floating)):
        yield path, np.asarray(out)
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _floats(v, f"{path}[{k!r}]")
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from _floats(v, f"{path}[{i}]")


def checked(fn):
    """``fn`` wrapped to raise ``FloatingPointError`` on the first output
    (tensor, array or float, in nested tuples, lists and dicts) holding a
    NaN or an infinity, naming it and the counts, instead of passing it
    on. A debug tool: each call reads its outputs back to the host."""
    name = getattr(fn, "__qualname__", repr(fn))

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, x in _floats(out, "output"):
            if isinstance(x, torch.Tensor):
                n_nan = int(torch.isnan(x).sum())
                n_inf = int(torch.isinf(x).sum())
            else:
                n_nan, n_inf = int(np.isnan(x).sum()), int(np.isinf(x).sum())
            if n_nan or n_inf:
                raise FloatingPointError(
                    f"{name}: {path} holds {n_nan} NaN and {n_inf} infinite "
                    f"value(s)")
        return out

    return wrapped
