"""Tracing and profiling (port of ``ganleaks_tpu.utils.profiling``):
the program's spans, stage annotations with cumulative throughput meters,
a profiler trace of a block of work and what its spans say, anomaly
detection and a non-finite output guard.

Spans (:func:`span`) are the program's named ranges at its layer
boundaries: on while a torch profiler records, a flag test otherwise.
Their names are ``<module>.<step>`` (``fbb.attack_arrays``,
``knn.plan``, ``lpips.tower``, ...), and bare for ``ops/knn.PhaseTimer``'s
phases (``featurize``, ``fold``). :func:`span_breakdown` reads them back
from a trace: host seconds per span, the device seconds each span
launched, and the card's idle time by the span the host was in.

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

import bisect
import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """The program's range ``name`` for the profiler: a
    ``torch.profiler.record_function`` range while a torch profiler is
    recording, otherwise one shared no-op context. Off, it costs a flag
    test: no synchronisation, no clock read, no allocation. The ranges
    share the device trace's clock and are kept by the profiler with its
    trace (:func:`profile_to` writes them into its Chrome trace)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


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
    """What :func:`profile_to` recorded: the Chrome trace's path, the
    profiler's events (``torch.profiler`` ``FunctionEvent`` s, CPU and
    device, on one clock in microseconds) and its raw events
    (:func:`trace_events`, in nanoseconds)."""

    trace_path: str | None = None
    events: list = field(default_factory=list)
    raw: list = field(default_factory=list)


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
    run.raw = trace_events(prof)
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


class TraceEvent(NamedTuple):
    """One raw profiler event as :func:`span_breakdown` reads it: times in
    ns on the profiler's one clock for the host and the card; ``corr``
    and ``linked`` are its correlation ids (a kernel and the CUDA runtime
    call that launched it share ``corr``; ``linked`` names the torch
    operation that was innermost at the launch, 0 where there was none)."""

    name: str
    on_host: bool
    start: int
    end: int
    thread: int
    corr: int
    linked: int
    annotation: bool


def trace_events(prof) -> list[TraceEvent]:
    """The raw events of a finished ``torch.profiler.profile``, read
    without building its ``FunctionEvent`` s (ten times faster on a long
    trace)."""
    cpu = torch.autograd.DeviceType.CPU
    return [TraceEvent(e.name(), e.device_type() == cpu, e.start_ns(),
                       e.end_ns(), e.start_thread_id(), e.correlation_id(),
                       e.linked_correlation_id(),
                       bool(e.is_user_annotation()))
            for e in prof.profiler.kineto_results.events()]


def _innermost_segments(ranges) -> list[tuple]:
    """``(start, end, name)`` pieces of one thread's nested ``ranges``
    (sorted by start, the enclosing one first where two start together),
    each piece labelled by the innermost range open over it."""
    out, stack, cursor = [], [], 0
    for r in ranges:
        while stack and stack[-1].end <= r.start:
            top = stack.pop()
            out.append((cursor, top.end, top.name))
            cursor = top.end
        if stack:
            out.append((cursor, r.start, stack[-1].name))
        stack.append(r)
        cursor = r.start
    while stack:
        top = stack.pop()
        out.append((cursor, top.end, top.name))
        cursor = top.end
    return [seg for seg in out if seg[1] > seg[0]]


def _overlaps(a, b):
    """``(start, end, label of b)`` of the overlaps of two sorted lists of
    disjoint ``(start, end, ...)`` intervals."""
    i = j = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            yield s, e, b[j][2]
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1


def _add(table: dict, name: str, ns: float) -> None:
    table[name] = table.get(name, 0.0) + ns / 1e9


def span_breakdown(events: list[TraceEvent], within: str) -> dict:
    """What the program's spans (host ranges: :func:`span` and every
    ``record_function``) say of the trace inside the ranges named
    ``within`` (one per timed call, say), on the thread that opened them:

    * ``spans``: host seconds per span name, inclusive of inner spans;
    * ``launched``: device seconds (kernels, copies, sets) per innermost
      span open on the host when each was launched: at the CUDA runtime
      call (``cu*``) that carries the device event's correlation id,
      never the span whose interval the device interval falls in (the
      card runs behind the host);
    * ``idle``: seconds inside the ranges in which nothing ran on the
      card, per innermost span the host was in then (each idle interval
      split at span boundaries);
    * ``window_s`` and ``busy_s``: the ranges' seconds and the card's busy
      seconds inside them.
    """
    windows = sorted((e.start, e.end) for e in events
                     if e.on_host and e.annotation and e.name == within)
    out = {"spans": {}, "launched": {}, "idle": {}, "busy_s": 0.0,
           "window_s": sum(b - a for a, b in windows) / 1e9}
    if not windows:
        return out
    thread = next(e.thread for e in events if e.on_host and e.annotation
                  and e.name == within)
    spans = sorted((e for e in events if e.on_host and e.annotation
                    and e.thread == thread), key=lambda e: (e.start, -e.end))
    segs = _innermost_segments(spans)
    seg_starts = [s[0] for s in segs]
    win_starts = [a for a, _ in windows]

    def clipped(start: int, end: int):
        """The parts of [start, end) inside the ranges."""
        i = max(0, bisect.bisect_right(win_starts, start) - 1)
        while i < len(windows) and windows[i][0] < end:
            a, b = max(start, windows[i][0]), min(end, windows[i][1])
            if b > a:
                yield a, b
            i += 1

    for s in spans:
        for a, b in clipped(s.start, s.end):
            _add(out["spans"], s.name, b - a)

    # the CUDA runtime and driver calls, by the correlation id they share
    # with their device work (torch operations number theirs apart, and
    # a kernel launched outside every operation links to none)
    launches = {e.corr: e for e in events
                if e.on_host and not e.annotation and e.name.startswith("cu")}
    pieces = []
    for d in events:
        if d.on_host or d.annotation:
            continue
        host = launches.get(d.corr)
        if (host is not None and host.thread == thread
                and any(clipped(host.start, host.start + 1))):
            i = bisect.bisect_right(seg_starts, host.start) - 1
            if i >= 0 and host.start < segs[i][1]:
                _add(out["launched"], segs[i][2], d.end - d.start)
        pieces.extend(clipped(d.start, d.end))
    busy = []
    for a, b in sorted(pieces):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    out["busy_s"] = sum(b - a for a, b in busy) / 1e9
    busy_starts = [a for a, _ in busy]
    gaps = []
    for a, b in windows:
        cursor = a
        for s, e in busy[bisect.bisect_left(busy_starts, a):]:
            if s >= b:
                break
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if b > cursor:
            gaps.append((cursor, b))
    for a, b, name in _overlaps(gaps, segs):
        _add(out["idle"], name, b - a)
    return out


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
