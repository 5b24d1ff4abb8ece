"""The trace's reduction with the program's spans in it (hand-built raw
events): a span's device-side annotation adds nothing to the busy time or
the device operations, idle gaps are named by the span the host was in,
the spans' host seconds and launched device seconds are the program's
``utils/profiling.span_breakdown``'s, and every metric reader reads the
same from records that carry more keys than it reads, and what the
readers read before configurations had modules."""

import glob
import json
import os
from types import SimpleNamespace

import pytest
import torch

from portbench import counting, run, trace
from portbench.tests.conftest import REPO

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class _Event:
    """The raw event methods ``trace.reduce`` calls."""

    def __init__(self, name, start, end, device=CUDA, annotation=False,
                 thread=1, corr=0):
        self._v = (name, start, end, device, annotation, thread, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]

    def linked_correlation_id(self):
        return 0


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _call(*inner):
    """One timed call [0, 100] ns holding a kernel [20, 40] and ``inner``
    events."""
    return [_Event(trace.CALL, 0, 100, CPU, annotation=True),
            _Event(trace.CALL, 0, 100, annotation=True),
            _Event("aten::mm", 12, 14, CPU),
            _Event("kernel", 20, 40), *inner]


def test_span_annotations_are_not_device_work():
    plain = trace.reduce(_prof(_call()))
    spanned = trace.reduce(_prof(_call(
        _Event("lpips.tower", 10, 30, CPU, annotation=True),
        _Event("lpips.tower", 20, 90, annotation=True))))
    for got in (plain, spanned):
        assert got["busy_s"] == pytest.approx(20e-9)
        assert got["ops"] == pytest.approx({"kernel": 20e-9})
        assert got["window_s"] == pytest.approx(100e-9)
        assert got["calls"] == 1
    # the gap [0, 20] has its midpoint inside the span, [40, 100] after it
    assert plain["idle"] == pytest.approx(
        {"(host between operations)": 80e-9})
    assert spanned["idle"] == pytest.approx(
        {"lpips.tower": 20e-9, "(host between operations)": 60e-9})
    assert plain["spans"] == pytest.approx({trace.CALL: 100e-9})
    assert spanned["spans"] == pytest.approx(
        {trace.CALL: 100e-9, "lpips.tower": 20e-9})
    assert plain["launched"] == spanned["launched"] == {}


def _two_calls():
    """Two timed calls on thread 1 with nested spans, the CUDA calls that
    launch each device event (matched by correlation id), a launch on
    another thread, a launch between the calls and a device annotation."""
    E = _Event
    events = []
    for c0, corr in ((0, 10), (1000, 20)):
        events += [
            E(trace.CALL, c0, c0 + 600, CPU, annotation=True),
            E("fbb.attack_arrays", c0 + 5, c0 + 590, CPU, annotation=True),
            E("knn.plan", c0 + 10, c0 + 60, CPU, annotation=True),
            E("featurize", c0 + 70, c0 + 300, CPU, annotation=True),
            E("lpips.tower", c0 + 80, c0 + 200, CPU, annotation=True),
            E("aten::conv2d", c0 + 90, c0 + 150, CPU),
            E("cudaLaunchKernel", c0 + 100, c0 + 104, CPU, corr=corr),
            E("cudaLaunchKernel", c0 + 210, c0 + 214, CPU, corr=corr + 1),
            E("cudaMemcpyAsync", c0 + 50, c0 + 52, CPU, corr=corr + 2),
            E("cudaLaunchKernel", c0 + 400, c0 + 403, CPU, corr=corr + 3),
            E("cudaLaunchKernel", c0 + 120, c0 + 121, CPU, thread=2,
              corr=corr + 4),
            E("conv_kernel", c0 + 110, c0 + 260, corr=corr),
            E("tap_epilogue", c0 + 260, c0 + 290, corr=corr + 1),
            E("Memcpy HtoD", c0 + 55, c0 + 75, corr=corr + 2),
            E("int8_fold_kernel", c0 + 405, c0 + 640, corr=corr + 3),
            E("other_thread_kernel", c0 + 300, c0 + 310, corr=corr + 4),
            E("lpips.tower", c0 + 110, c0 + 250, annotation=True),
        ]
    events += [E("cudaLaunchKernel", 800, 802, CPU, corr=99),
               E("next_input_kernel", 805, 900, corr=99)]
    return events


def test_spans_and_launched_are_the_programs():
    from ganleaks_tpu_torch.utils.profiling import TraceEvent, span_breakdown

    events = _two_calls()
    got = trace.reduce(_prof(events))
    raw = [TraceEvent(e.name(), e.device_type() == CPU, e.start_ns(),
                      e.end_ns(), e.start_thread_id(), e.correlation_id(),
                      e.linked_correlation_id(), e.is_user_annotation())
           for e in events]
    want = span_breakdown(raw, trace.CALL)
    assert got["spans"] == want["spans"]
    assert got["launched"] == want["launched"]
    # by hand: a kernel counts whole for the span open at its launch
    assert got["launched"] == pytest.approx({
        "lpips.tower": 2 * 150e-9, "featurize": 2 * 30e-9,
        "knn.plan": 2 * 20e-9, "fbb.attack_arrays": 2 * 235e-9})
    assert got["spans"] == pytest.approx({
        trace.CALL: 1200e-9, "fbb.attack_arrays": 2 * 585e-9,
        "knn.plan": 100e-9, "featurize": 2 * 230e-9,
        "lpips.tower": 2 * 120e-9})
    assert got["window_s"] == pytest.approx(want["window_s"])
    assert got["busy_s"] == pytest.approx(want["busy_s"])


def _records():
    """Records of three timed calls of the VGG16 cell (one featurising
    the queries, one failed), with a trace."""
    with open(os.path.join(REPO, "portbench", "configs",
                           "lpips-vgg16-64.json")) as f:
        config = json.load(f)
    base = {"ok": True, "n_q": 20_000, "n_s": 100_000, "oom_resumes": 0,
            "sets_on_device": True, "plan": {"sweeps": 1},
            "counters": {"query_rows_featurised": 0,
                         "query_rows_reused": 20_000}}
    calls = [
        dict(base, seconds=2.31, featurize_s=0.78, fold_s=1.27,
             lpips_init_s=0.021, host_copy_s=0.19, query_reused=True,
             k2_launches=65),
        dict(base, seconds=3.07, featurize_s=0.95, fold_s=1.29,
             lpips_init_s=0.35, host_copy_s=0.41, query_reused=False,
             k2_launches=75),
        {"seconds": 0.43, "ok": False, "n_q": 20_000, "n_s": 100_000,
         "k2_launches": 0},
    ]
    return {"cell": {}, "config": config,
            "module": run.config_module(config, REPO), "calls": calls,
            "setup_s": 14.3, "device_kind": "NVIDIA H100 80GB HBM3",
            "trace": {"busy_s": 5.52, "window_s": 5.81, "calls": 3,
                      "ops": {"tap_epilogue_bulk": 0.161,
                              "int8_fold_kernel": 2.55},
                      "idle": {"fbb.resolve_engine": 0.05},
                      "spans": {"knn.plan": 0.21, "lpips.tower": 0.17,
                                "fbb.resolve_engine": 0.06},
                      "launched": {"lpips.tower": 1.31, "fold": 2.55}}}


READERS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(REPO, "portbench", "metrics", "*.py")))

# what each reader read from :func:`_records` before configurations had
# modules and traces had spans
BEFORE = {
    "attack_mfu": 45.21667866925185,
    "device.idle_share": 4.991394148020656,
    "featurise.images_per_s": 127167.63005780347,
    "fold.pairs_per_s": 1562500000.0,
    "fold.roofline": 80.8489135927236,
    "k2.roofline": 61.15033280800964,
    "pairs_per_s": 688468158.3476765,
    "setup.host_share": 16.712564543889844,
    "setup_s": 14.3,
}


@pytest.mark.parametrize("name", READERS)
def test_readers_ignore_further_trace_keys(name):
    read = run.reader(name, REPO)
    want = read(_records())
    more = _records()
    more["trace"]["per_stream"] = {"7": 5.5}
    more["calls"][0]["clock_mhz"] = 1_890
    assert read(more) == want
    assert want is not None


@pytest.mark.parametrize("name", sorted(BEFORE))
def test_readers_read_what_they_read_before(name):
    assert run.reader(name, REPO)(_records()) == BEFORE[name]


def test_tower_roofline():
    r = _records()
    images = 100_000 + 120_000  # the second call featurised the queries
    flops = images * counting.tower_flops("vgg", 64)
    assert flops == images * 2_505_572_352
    read = run.reader("tower.roofline", REPO)
    assert read(r) == pytest.approx(100.0 * flops / 989e12 / 1.31)
    r["trace"]["launched"].pop("lpips.tower")
    assert read(r) is None
    r["trace"] = None
    assert read(r) is None


def test_plan_host_share():
    r = _records()
    read = run.reader("plan.host_share", REPO)
    assert read(r) == pytest.approx(100.0 * (0.21 + 0.06) / 5.81)
    r["trace"]["spans"] = {"lpips.tower": 0.17}
    assert read(r) is None
    r["trace"] = None
    assert read(r) is None
