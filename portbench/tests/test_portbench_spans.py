"""The trace's reduction with the program's spans in it (hand-built raw
events): a span's device-side annotation adds nothing to the busy time or
the device operations, idle gaps are named by the span the host was in,
and every metric reader reads the same from records that carry more keys
in their trace than it reads."""

import glob
import json
import os
from types import SimpleNamespace

import pytest
import torch

from portbench import run, trace
from portbench.tests.conftest import REPO

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class _Event:
    """The raw event methods ``trace.reduce`` calls."""

    def __init__(self, name, start, end, device=CUDA, annotation=False,
                 thread=1):
        self._v = (name, start, end, device, annotation, thread)

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


def _records():
    """Records of two timed calls of the VGG16 cell, with a trace."""
    with open(os.path.join(REPO, "portbench", "configs",
                           "lpips-vgg16-64.json")) as f:
        config = json.load(f)
    call = {"seconds": 4.0, "ok": True, "n_q": 20_000, "n_s": 100_000,
            "featurize_s": 1.2, "fold_s": 2.2, "lpips_init_s": 0.2,
            "host_copy_s": 0.1, "oom_resumes": 0, "query_reused": True,
            "sets_on_device": True, "k2_launches": 500,
            "plan": {"sweeps": 1}}
    return {"cell": {}, "config": config, "calls": [call, dict(call)],
            "setup_s": 15.0, "device_kind": "NVIDIA H100 80GB HBM3",
            "trace": {"busy_s": 7.0, "window_s": 8.0, "calls": 2,
                      "ops": {"tap_epilogue_bulk": 0.15, "gemm": 4.2},
                      "idle": {"fbb.resolve_engine": 0.5}}}


READERS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(REPO, "portbench", "metrics", "*.py")))


@pytest.mark.parametrize("name", READERS)
def test_readers_ignore_further_trace_keys(name):
    read = run.reader(name, REPO)
    want = read(_records())
    more = _records()
    more["trace"].update(spans={"knn.plan": 0.3, "lpips.tower": 2.0},
                         launched={"lpips.tower": 0.6, "fold": 4.0})
    assert read(more) == want
    assert want is not None
