"""The port's spans and counters (``utils/profiling.span``,
``span_breakdown``; the spans of ``attack/fbb``, ``ops/knn``,
``ops/lpips`` and ``ops/distance``; ``attack_arrays``' ``counters``) on
the CPU: which spans a call records and how they nest, that no range is
opened while no profiler records, that the phase timer's seconds are
unchanged, the query-reuse and candidate-union counters, and the
reduction of a trace by span (kernels attributed by correlation)."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from ganleaks_tpu_torch.attack.fbb import (attack_arrays, build_embed_fn,
                                           resolve_auto_engine)
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.ops import knn
from ganleaks_tpu_torch.utils import profiling
from ganleaks_tpu_torch.utils.profiling import TraceEvent


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sets(res=8, n_syn=40, n_q=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n_syn, res, res, 3), np.uint8),
            rng.integers(0, 256, (n_q, res, res, 3), np.uint8),
            rng.integers(0, 256, (n_q, res, res, 3), np.uint8))


LPIPS_INT8 = AttackConfig(distance="l2-lpips", resolution=32,
                          engine="taps-int8", dtype="bfloat16",
                          lpips_compute_dtype="bfloat16", query_block=4,
                          syn_block=8, save_plots=False)


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` inside a range named 'test':
    (its result, the raw events)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test"):
            out = fn()
    return out, profiling.trace_events(prof)


def _ranges(events) -> dict:
    """Host ranges by name: a list of (start, end)."""
    out: dict = {}
    for e in events:
        if e.on_host and e.annotation:
            out.setdefault(e.name, []).append((e.start, e.end))
    return out


def _inside(inner, outer) -> bool:
    """Every range of ``inner`` lies within one of ``outer``."""
    return all(any(a <= s and t <= b for a, b in outer) for s, t in inner)


ATTACK_SPANS = ("fbb.attack_arrays", "fbb.embeds", "fbb.stage_sets",
                "knn.plan", "knn.query_cache", "featurize",
                "distance.pixels", "lpips.tower", "lpips.epilogue", "fold",
                "fbb.readback")


def test_attack_spans_and_their_nesting():
    """A CPU 'taps-int8' call records the span of every layer it crosses:
    the tower, its epilogue and the pixel part inside each featurise
    block, the query blocks inside the query cache's span, and
    everything inside the call's; 'auto' resolution records its own."""
    syn, pos, neg = _sets(res=32, n_syn=12, n_q=3)

    def calls():
        attack_arrays(LPIPS_INT8, syn, pos, neg, device="cpu")
        resolve_auto_engine(replace(LPIPS_INT8, engine="auto"), "cuda")

    _, events = _profiled(calls)
    got = _ranges(events)
    assert set(ATTACK_SPANS) <= set(got), set(ATTACK_SPANS) - set(got)
    assert len(got["fbb.attack_arrays"]) == 1
    assert "fbb.resolve_engine" in got
    assert not _inside(got["fbb.resolve_engine"], got["fbb.attack_arrays"])
    for name in ATTACK_SPANS[1:]:
        assert _inside(got[name], got["fbb.attack_arrays"]), name
    for name in ("lpips.tower", "lpips.epilogue", "distance.pixels"):
        # the one-image probes of the plan run the tower outside a block
        blocks = got["featurize"] + got["knn.plan"]
        assert _inside(got[name], blocks), name
    assert any(_inside([t], got["featurize"]) for t in got["lpips.tower"])
    assert _inside(got["lpips.epilogue"], got["featurize"])
    # 6 query rows in blocks of 4, 12 synthetic rows in blocks of 8
    assert len(got["featurize"]) == 2 + 2 and len(got["fold"]) == 2
    assert sum(_inside([f], got["knn.query_cache"])
               for f in got["featurize"]) == 2


def test_two_pass_spans():
    """The two-pass mode's passes are spans of the call: pass 1, the
    re-rank, the certificate and (here every query fails it) the
    fallback."""
    syn, pos, neg = _sets()
    cfg = AttackConfig(distance="l2", resolution=8, two_pass=True,
                       two_pass_k=2, save_plots=False)
    embed_lo = build_embed_fn(replace(cfg, dtype="bfloat16"))
    embed_hi = build_embed_fn(cfg)
    queries = np.concatenate([pos, neg])
    _, events = _profiled(lambda: knn.knn_argmin_two_pass(
        embed_lo, embed_hi, queries, syn, k=2, cert_eta=1e3))
    got = _ranges(events)
    for name in ("knn.plan", "knn.topk", "knn.rerank", "knn.certificate",
                 "knn.fallback"):
        assert len(got.get(name, ())) >= 1, name
    for name in ("knn.topk", "knn.rerank", "knn.fallback"):
        assert any(_inside([f], got[name]) for f in got["fold"]), name


class _Counting:
    """Stands in for ``torch.profiler.record_function``: counts the ranges
    entered."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_no_range_opened_without_a_profiler(monkeypatch):
    """With no profiler recording, ``span`` hands out one shared no-op
    context and no range is entered; under a profiler the same calls
    enter ranges (the control: the patched function is the one used)."""
    monkeypatch.setattr(_Counting, "entered", 0)
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    syn, pos, neg = _sets(res=32, n_syn=12, n_q=3)
    assert profiling.span("a") is profiling.span("b")
    attack_arrays(LPIPS_INT8, syn, pos, neg, device="cpu")
    attack_arrays(replace(LPIPS_INT8, two_pass=True), syn, pos, neg,
                  device="cpu")
    assert _Counting.entered == 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("a"), _Counting)
        attack_arrays(LPIPS_INT8, syn, pos, neg, device="cpu")
    assert _Counting.entered > len(ATTACK_SPANS)


@pytest.mark.parametrize("traced", [False, True])
def test_phase_timer_keys_unchanged(traced):
    """The timer's seconds keep their keys under a profiler and without
    one, and each timed phase is one span of its name."""
    syn, pos, neg = _sets()
    embed = build_embed_fn(AttackConfig(distance="l2", resolution=8),
                           structured=True)
    timer = knn.PhaseTimer(torch.device("cpu"))

    def search():
        return knn.knn_argmin_streamed(
            embed, np.concatenate([pos, neg]), syn, engine="taps-int8",
            q_block=4, s_block=8, timer=timer)

    if traced:
        _, events = _profiled(search)
        got = _ranges(events)
        for phase in ("featurize", "fold"):
            assert len(got[phase]) == len(timer._marks[phase])
    else:
        search()
    secs = timer.seconds()
    assert set(secs) == {"featurize", "fold"}
    assert all(v > 0 for v in secs.values())


class _Records:
    """A logger that keeps what it is given."""

    def __init__(self):
        self.records = []

    def log(self, record, step=None):
        self.records.append(record)


@pytest.mark.parametrize("engine", ["gemm", "taps", "taps-int8"])
def test_query_row_counters(engine):
    """A first call featurises and stages every query row and reuses
    none; a second call with the same ``sweep_cache`` reuses all of them
    and stages none. The logged record carries the same counters."""
    syn, pos, neg = _sets()
    cfg = AttackConfig(distance="l2", resolution=8, engine=engine,
                       query_block=4, syn_block=8, save_plots=False)
    cache: dict = {}
    n_q = len(pos) + len(neg)
    logger = _Records()
    first = attack_arrays(cfg, syn, pos, neg, device="cpu",
                          sweep_cache=cache, logger=logger)
    second = attack_arrays(cfg, syn, pos, neg, device="cpu",
                           sweep_cache=cache, logger=logger)
    # every call folds the 40 synthetic rows in 5 blocks; 'taps-int8'
    # folds them in the int8 fold kernel's route (192-byte pixel rows)
    folds = {"int8_fold_kernel_blocks": 5 if engine == "taps-int8" else 0,
             "int8_fold_parts_blocks": 0,
             # distance 'l2' runs no LPIPS tower
             "tower_epilogue_kernel_convs": 0,
             "tower_epilogue_plain_convs": 0}
    assert first["counters"] == {"query_rows_featurised": n_q,
                                 "query_rows_reused": 0,
                                 "query_rows_staged": n_q, **folds}
    assert second["counters"] == {"query_rows_featurised": 0,
                                  "query_rows_reused": n_q,
                                  "query_rows_staged": 0, **folds}
    assert [r["counters"] for r in logger.records
            if "counters" in r] == [first["counters"], second["counters"]]
    alone = attack_arrays(cfg, syn, pos, neg, device="cpu")
    assert alone["counters"]["query_rows_reused"] == 0


def test_rerank_candidates_is_the_union():
    """``rerank_candidates`` is the size of the union of every query's
    pass-1 top-k, here computed apart in float64 on the same bfloat16
    embeddings; a call without two-pass has no such counter."""
    syn, pos, neg = _sets(n_syn=64, n_q=4, seed=5)
    cfg = AttackConfig(distance="l2", resolution=8, two_pass=True,
                       two_pass_k=2, query_block=4, syn_block=16,
                       save_plots=False)
    out = attack_arrays(cfg, syn, pos, neg, device="cpu")
    embed_lo = build_embed_fn(replace(cfg, dtype="bfloat16"))
    q = embed_lo(torch.from_numpy(np.concatenate([pos, neg]))).double()
    s = embed_lo(torch.from_numpy(syn)).double()
    d = torch.cdist(q, s) ** 2
    union = np.unique(torch.topk(d, 2, largest=False).indices.numpy())
    assert len(union) < len(syn)
    assert out["counters"]["rerank_candidates"] == len(union)
    one = attack_arrays(replace(cfg, two_pass=False), syn, pos, neg,
                        device="cpu")
    assert "rerank_candidates" not in one["counters"]


def _host(name, start, end, corr=0, linked=0, annotation=False, thread=1):
    return TraceEvent(name, True, start, end, thread, corr, linked,
                      annotation)


def _device(name, start, end, corr, linked, annotation=False):
    return TraceEvent(name, False, start, end, 0, corr, linked, annotation)


def test_span_breakdown_attributes_kernels_by_correlation():
    """A kernel belongs to the span open when its runtime call ran (the
    call sharing its correlation ids), not to the span whose host
    interval its device interval falls in; device-side annotations add
    no busy time; idle time is split at span boundaries."""
    events = [
        _host("call", 0, 100, corr=1, annotation=True),
        _host("lpips.tower", 10, 30, corr=2, annotation=True),
        _host("fold", 40, 60, corr=3, annotation=True),
        _host("aten::conv", 12, 20, corr=7),
        _host("cudaLaunchKernel", 15, 16, corr=501, linked=7),
        # a torch operation whose own id equals the kernel's: not its
        # launch (its linked id is 0)
        _host("aten::add", 61, 62, corr=501),
        _host("cudaLaunchKernel", 45, 46, corr=502, linked=8),
        # a kernel of the program's own library, launched under no torch
        # operation (linked 0), whose id a torch operation also carries
        _host("cuLaunchKernel", 25, 26, corr=7),
        _device("conv_kernel", 50, 80, corr=501, linked=7),
        _device("gemm_kernel", 85, 95, corr=502, linked=8),
        _device("epilogue_kernel", 80, 82, corr=7, linked=0),
        _device("fold", 50, 95, corr=3, linked=0, annotation=True),
        # launched outside the call: counts for no span
        _host("cudaLaunchKernel", 105, 106, corr=503, linked=9),
        _device("late_kernel", 107, 120, corr=503, linked=9),
    ]
    out = profiling.span_breakdown(events, "call")
    assert out["launched"] == pytest.approx({"lpips.tower": 32e-9,
                                             "fold": 10e-9})
    assert out["window_s"] == pytest.approx(100e-9)
    assert out["busy_s"] == pytest.approx(42e-9)
    # idle: [0, 50] and [82, 85] and [95, 100]; host segments: call
    # [0, 10], tower [10, 30], call [30, 40], fold [40, 60], call [60, 100]
    assert out["idle"] == pytest.approx({"call": 28e-9,
                                         "lpips.tower": 20e-9,
                                         "fold": 10e-9})
    assert out["spans"] == pytest.approx({"call": 100e-9,
                                          "lpips.tower": 20e-9,
                                          "fold": 20e-9})
    assert profiling.span_breakdown(events, "absent")["spans"] == {}


def test_span_breakdown_of_a_cpu_trace():
    """On a real (CPU) trace every idle second of the calls is named by a
    program span, and the spans' host seconds lie within the calls'."""
    syn, pos, neg = _sets(res=32, n_syn=12, n_q=3)

    def two_calls():
        cache: dict = {}
        for _ in range(2):
            with torch.profiler.record_function("call"):
                attack_arrays(LPIPS_INT8, syn, pos, neg, device="cpu",
                              sweep_cache=cache)

    _, events = _profiled(two_calls)
    out = profiling.span_breakdown(events, "call")
    assert out["busy_s"] == 0 and out["launched"] == {}
    assert sum(out["idle"].values()) == pytest.approx(out["window_s"])
    assert set(out["idle"]) <= {"call", *ATTACK_SPANS}
    assert out["spans"]["call"] == pytest.approx(out["window_s"])
    for name in ATTACK_SPANS:
        assert 0 < out["spans"][name] <= out["window_s"], name
