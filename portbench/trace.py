"""The traced run: ``torch.profiler`` over the window, each timed call in a
``portbench.call`` range, and the reduction of the trace to what the
per-layer metrics and the ``breakdown`` read.

Device activity is every non-annotation event the profiler puts on the
card (kernels, copies, sets). Only what lies inside the timed calls'
ranges counts: making the next call's input runs between them. The busy
time is the union of the intervals clipped to those ranges. The
program's spans (its ``utils/profiling.span`` ranges, host annotations)
give host seconds per span and device seconds per launching span, by the
arithmetic of the program's ``utils/profiling.span_breakdown``, copied.
"""

from __future__ import annotations

import bisect
import contextlib

import torch

CALL = "portbench.call"
TOP = 10


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields the profiler (CPU and CUDA activity) or None."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def call_range(prof):
    """The range of one timed call (nothing without the profiler)."""
    if prof is None:
        return contextlib.nullcontext()
    return torch.profiler.record_function(CALL)


def _is_annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof) -> dict:
    """What the trace says about the timed calls: ``busy_s`` and
    ``window_s`` (seconds, summed over the calls), ``ops`` (device seconds
    per operation name, inside the calls), ``idle`` (idle seconds inside
    the calls per host operation that was running then, or '(host
    between operations)'), ``spans`` (host seconds per span name inside
    the calls, inner spans included) and ``launched`` (device seconds per
    innermost span open on the host when each kernel, copy or set was
    launched, matched by correlation id). Reads the profiler's raw events
    (times in ns on one clock for the host and the card)."""
    cpu = torch.autograd.DeviceType.CPU
    host, device, calls = [], [], []
    marks, launches = [], {}
    thread = None
    for e in prof.profiler.kineto_results.events():
        s, t, name = e.start_ns(), e.end_ns(), e.name()
        if e.device_type() == cpu:
            th = e.start_thread_id()
            if name == CALL:
                calls.append((s, t))
                thread = th
            else:
                host.append((s, t, name, th))
            if _is_annotation(e):
                marks.append((s, t, name, th))
            elif name.startswith("cu"):
                # the CUDA API calls (``cuda*``, ``cu*``), by the
                # correlation id they share with their device work
                launches[e.correlation_id()] = (s, th)
        elif not _is_annotation(e):
            device.append((s, t, name, e.correlation_id()))
    by_span = _by_span(marks, launches, device)
    calls.sort()
    device.sort()
    starts = [c[0] for c in calls]
    ops: dict[str, float] = {}
    inside = []
    for s, e, name, _corr in device:
        i = bisect.bisect_right(starts, s) - 1
        if i < 0:
            continue
        c0, c1 = calls[i]
        s, e = max(s, c0), min(e, c1)
        if e > s:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
            inside.append((s, e))
    busy = _union(inside)
    gaps = []
    for c0, c1 in calls:
        lo = bisect.bisect_left(busy, [c0, c0])
        cursor = c0
        for s, e in busy[lo:]:
            if s >= c1:
                break
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if c1 > cursor:
            gaps.append((cursor, c1))
    # by start, the enclosing operation first where two start together
    ops_host = sorted(((s, t, name) for s, t, name, th in host
                       if th == thread), key=lambda o: (o[0], -o[1]))
    return {"busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": sum(c1 - c0 for c0, c1 in calls) / 1e9,
            "calls": len(calls), "ops": ops,
            "idle": _idle_by_host(gaps, ops_host), **by_span}


def _by_span(marks, launches, device) -> dict:
    """``spans`` and ``launched`` of :func:`reduce` from the host
    annotations ``marks`` (start, end, name, thread), the CUDA calls
    ``launches`` (correlation id: (start, thread)) and the ``device``
    events (start, end, name, correlation id), on the thread that opened
    the timed calls' ranges."""
    out = {"spans": {}, "launched": {}}
    windows = sorted((s, t) for s, t, name, _th in marks if name == CALL)
    if not windows:
        return out
    thread = next(th for _s, _t, name, th in marks if name == CALL)
    spans = sorted((m for m in marks if m[3] == thread),
                   key=lambda m: (m[0], -m[1]))
    segs = _innermost_segments(spans)
    seg_starts = [g[0] for g in segs]
    win_starts = [a for a, _ in windows]

    def clipped(start: int, end: int):
        """The parts of [start, end) inside the ranges."""
        i = max(0, bisect.bisect_right(win_starts, start) - 1)
        while i < len(windows) and windows[i][0] < end:
            a, b = max(start, windows[i][0]), min(end, windows[i][1])
            if b > a:
                yield a, b
            i += 1

    for s, t, name, _th in spans:
        for a, b in clipped(s, t):
            _add(out["spans"], name, b - a)
    for s, t, _name, corr in device:
        launch = launches.get(corr)
        if (launch is not None and launch[1] == thread
                and any(clipped(launch[0], launch[0] + 1))):
            i = bisect.bisect_right(seg_starts, launch[0]) - 1
            if i >= 0 and launch[0] < segs[i][1]:
                _add(out["launched"], segs[i][2], t - s)
    return out


def _innermost_segments(ranges) -> list[tuple]:
    """``(start, end, name)`` pieces of one thread's nested ``ranges``
    (sorted by start, the enclosing one first where two start together),
    each piece labelled by the innermost range open over it."""
    out, stack, cursor = [], [], 0
    for r in ranges:
        while stack and stack[-1][1] <= r[0]:
            top = stack.pop()
            out.append((cursor, top[1], top[2]))
            cursor = top[1]
        if stack:
            out.append((cursor, r[0], stack[-1][2]))
        stack.append(r)
        cursor = r[0]
    while stack:
        top = stack.pop()
        out.append((cursor, top[1], top[2]))
        cursor = top[1]
    return [seg for seg in out if seg[1] > seg[0]]


def _add(table: dict, name: str, ns: float) -> None:
    table[name] = table.get(name, 0.0) + ns / 1e9


def _idle_by_host(gaps, ops_host) -> dict[str, float]:
    """Idle seconds per innermost host operation covering each gap's
    midpoint (host operations of one thread nest)."""
    out: dict[str, float] = {}
    stack: list[tuple] = []
    j = 0
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        while j < len(ops_host) and ops_host[j][0] <= mid:
            s = ops_host[j][0]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append(ops_host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "(host between operations)"
        out[name] = out.get(name, 0.0) + (g1 - g0) / 1e9
    return out


def top(table: dict[str, float], n: int = TOP) -> list[list]:
    """The ``n`` largest entries as [name, seconds], largest first."""
    return [[k, v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])
            [:n]]
