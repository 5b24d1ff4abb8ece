"""The port's profiling helpers (``utils/profiling``) and its three card
tools on the CPU: ``tools/hbm_projection`` (against the plans the attack
itself makes), ``tools/profile_attack`` and ``tools/tune_knn`` at tiny
sizes with ``--device cpu``, and their refusal without a GPU."""

import json
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ganleaks_tpu_torch.ops import knn, stream_plan
from ganleaks_tpu_torch.tools import hbm_projection, profile_attack, tune_knn
from ganleaks_tpu_torch.utils import profiling

GIB = 1 << 30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several processes
    yield
    torch.set_num_threads(n)


def test_trace_stage_meters_are_cumulative():
    meters: dict = {}
    for items in (3, 5):
        with profiling.trace_stage("embed", meters, items=items,
                                   device="cpu"):
            torch.ones(8).sum()
    assert meters["embed_items"] == 8
    assert meters["embed_seconds"] > 0
    assert meters["embed_items_per_sec"] == pytest.approx(
        8 / meters["embed_seconds"])
    with profiling.trace_stage("fold", meters, device="cpu"):
        pass
    assert "fold_items" not in meters and meters["fold_seconds"] >= 0


def test_trace_stage_name_in_a_cpu_trace(tmp_path):
    with profiling.profile_to(str(tmp_path), device="cpu") as run:
        with profiling.trace_stage("stage_in_trace", device="cpu"):
            torch.ones(64) @ torch.ones(64)
    assert os.path.dirname(run.trace_path) == str(tmp_path)
    with open(run.trace_path) as f:
        trace = json.load(f)
    assert any(e.get("name") == "stage_in_trace"
               for e in trace["traceEvents"])
    lo, hi = profiling.stage_window(run.events, "stage_in_trace")
    assert hi > lo
    assert profiling.device_activity(run.events) == []
    with profiling.profile_to(None) as none:
        assert none is None


def test_profile_to_refuses_a_cuda_run_without_device_activity(
        tmp_path, monkeypatch):
    """No CPU-only trace passes for a run on a card: with CUDA asked for
    and no device activity recorded (here: no card at all), it raises."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        with profiling.profile_to(str(tmp_path), device="cuda"):
            torch.ones(4) + 1


def _event(name, start, end, cpu=False, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=(torch.autograd.DeviceType.CPU if cpu
                     else torch.autograd.DeviceType.CUDA),
        is_user_annotation=annotation)


def test_kernel_table_and_idle_share_from_intervals():
    events = [_event("search", 0, 100, cpu=True, annotation=True),
              _event("search", 5, 95, annotation=True),  # GPU-side range
              _event("k_a", 10, 30), _event("k_b", 20, 40),
              _event("k_a", 50, 60), _event("k_c", 90, 120),
              _event("aten::mm", 0, 50, cpu=True)]
    act = profiling.device_activity(events)
    assert [a[0] for a in act] == ["k_a", "k_b", "k_a", "k_c"]
    table = profiling.kernel_table(act)
    assert [(r["name"], r["launches"]) for r in table] == [
        ("k_a", 2), ("k_c", 1), ("k_b", 1)]
    assert table[0]["total_ms"] == pytest.approx(0.03)
    assert profiling.stage_window(events, "search") == (0, 100)
    # busy: [10, 40] + [50, 60] + [90, 100] = 50 of 100; the GPU-side
    # range is no device work
    raw = [profiling.TraceEvent(
        e.name, e.device_type == torch.autograd.DeviceType.CPU,
        e.time_range.start, e.time_range.end, 1, 0, 0,
        e.is_user_annotation) for e in events]
    spans = profiling.span_breakdown(raw, "search")
    assert spans["busy_s"] / spans["window_s"] == pytest.approx(0.5)


@pytest.mark.parametrize("bad", ["nan_tensor", "inf_array", "nested"])
def test_checked_raises_on_non_finite_output(bad):
    def fn(x):
        if bad == "nan_tensor":
            return x / 0.0 * 0.0
        if bad == "inf_array":
            return np.float32(1.0), np.full(3, np.inf, np.float32)
        return {"ok": x, "bad": [x, torch.tensor([1.0, float("nan")])]}

    with pytest.raises(FloatingPointError, match="NaN|infinite") as exc:
        profiling.checked(fn)(torch.ones(2))
    assert "output" in str(exc.value)


def test_checked_passes_finite_output():
    out = profiling.checked(lambda x: (x * 2, torch.arange(3), {"n": 1.5})
                            )(torch.ones(2))
    assert out[0].tolist() == [2.0, 2.0]


def test_enable_nan_debugging_toggles_anomaly_mode():
    was = torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_debugging(True)
        assert torch.is_anomaly_enabled()
        profiling.enable_nan_debugging(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)


def test_call_seconds_on_the_cpu():
    calls = []
    t = profiling.call_seconds(lambda: calls.append(1), "cpu", reps=3)
    assert len(calls) == 4 and t >= 0


NS = dict(n_q=20000, n_syn=100000, resolution=64)


def test_projection_plans_the_north_star_in_one_sweep():
    """At 80 GiB the 'auto' recipe caches every query row: 20,480 rows of
    512,000 int8 bytes (9.77 GiB), one sweep — the plan the card made
    (PERF.md §5); below that one-sweep need it takes more sweeps."""
    p = hbm_projection.project(engine="auto", store="uint8", mem_gb=80.0,
                               **NS)
    assert p["engine"] == "taps-int8" and p["row_bytes"] == 512000
    assert p["sweeps"] == 1 and p["cache_bytes"] == 20480 * 512000
    assert p["sets_on_device"] and p["fits"]
    small = hbm_projection.project(engine="auto", store="uint8",
                                   mem_gb=8.0, **NS)
    assert small["sweeps"] > 1 and small["cache_bytes"] < p["cache_bytes"]
    assert not small["sets_on_device"]


def test_projection_int8_rows_are_half_the_bf16_rows():
    kw = dict(store="uint8", q_block=2048, s_block=2048, **NS)
    i8 = hbm_projection.project(engine="taps-int8", dtype="bfloat16", **kw)
    bf = hbm_projection.project(engine="taps", dtype="bfloat16", **kw)
    assert 2 * i8["row_bytes"] == bf["row_bytes"] == 1024000


def test_projection_calls_the_planner(monkeypatch):
    seen = []
    real = knn.plan_stream

    def spy(*a, **kw):
        seen.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(knn, "plan_stream", spy)
    p = hbm_projection.project(engine="auto", capacity_bytes=12 * GIB, **NS)
    assert len(seen) == 1 and seen[0]["capacity_bytes"] == 12 * GIB
    assert p["capacity_bytes"] == 12 * GIB


@pytest.mark.parametrize("capacity", [1 << 28, 11 << 20])
def test_projection_equals_the_attacks_own_plan(monkeypatch, capacity):
    """The projection at a budget equals the plan ``attack_arrays`` makes
    when the planner reads that budget (here on the CPU, with the budget
    given to ``stream_plan.device_capacity``)."""
    from ganleaks_tpu_torch.attack.fbb import attack_arrays
    from ganleaks_tpu_torch.config import AttackConfig

    monkeypatch.setattr(stream_plan, "device_capacity",
                        lambda device: capacity)
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 256, (6, 32, 32, 3), np.uint8)
    neg = rng.integers(0, 256, (6, 32, 32, 3), np.uint8)
    syn = rng.integers(0, 256, (20, 32, 32, 3), np.uint8)
    cfg = AttackConfig(engine="taps-int8", dtype="bfloat16",
                       lpips_compute_dtype="bfloat16", resolution=32,
                       query_block=4, syn_block=8, save_plots=False)
    plan = attack_arrays(cfg, syn, pos, neg, device="cpu")["plan"]
    proj = hbm_projection.project(12, 20, 32, engine="taps-int8",
                                  dtype="bfloat16", q_block=4, s_block=8,
                                  capacity_bytes=capacity,
                                  tower_dtype="bfloat16")
    assert plan["capacity_bytes"] == capacity
    assert {k: proj[k] for k in ("cache_bytes", "s_block", "q_block",
                                 "sweeps")} == \
        {k: plan[k] for k in ("cache_bytes", "s_block", "q_block",
                              "sweeps")}
    if capacity < 1 << 28:
        assert proj["sweeps"] > 1


def test_projection_round_trips_a_plan_with_a_held_cache(monkeypatch):
    """A search that reuses a held query cache plans with that cache
    credited to the budget; the plan's ``capacity_bytes`` holds the
    credit, so the projection at it gives the same plan."""
    from ganleaks_tpu_torch.attack.fbb import attack_arrays
    from ganleaks_tpu_torch.config import AttackConfig

    capacity = 1 << 28
    monkeypatch.setattr(stream_plan, "device_capacity",
                        lambda device: capacity)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 256, (6, 32, 32, 3), np.uint8)
    neg = rng.integers(0, 256, (6, 32, 32, 3), np.uint8)
    syn = rng.integers(0, 256, (20, 32, 32, 3), np.uint8)
    cfg = AttackConfig(engine="taps-int8", dtype="bfloat16",
                       lpips_compute_dtype="bfloat16", resolution=32,
                       query_block=4, syn_block=8, save_plots=False)
    cache: dict = {}
    attack_arrays(cfg, syn, pos, neg, device="cpu", sweep_cache=cache)
    plan = attack_arrays(cfg, syn, pos, neg, device="cpu",
                         sweep_cache=cache)["plan"]
    assert plan["query_reused"] and plan["capacity_bytes"] > capacity
    proj = hbm_projection.project(12, 20, 32, engine="taps-int8",
                                  dtype="bfloat16", q_block=4, s_block=8,
                                  capacity_bytes=plan["capacity_bytes"],
                                  tower_dtype="bfloat16")
    assert {k: proj[k] for k in ("cache_bytes", "s_block", "q_block",
                                 "sweeps")} == \
        {k: plan[k] for k in ("cache_bytes", "s_block", "q_block",
                              "sweeps")}


def test_projection_cli_prints_the_plan(capsys):
    assert hbm_projection.main(["--n_q", "100", "--n_syn", "200",
                                "--resolution", "32", "--mem_gb", "80"]) == 0
    out = capsys.readouterr().out
    assert "sweeps: 1" in out and "fits: True" in out


def test_profile_attack_on_the_cpu(capsys):
    with tempfile.TemporaryDirectory() as tmp:
        assert profile_attack.main(["--device", "cpu", "--n_q", "4",
                                    "--n_syn", "6", "--block", "4",
                                    "--res", "32", "--trace_dir",
                                    tmp]) == 0
        lines = [json.loads(ln) for ln in
                 capsys.readouterr().out.strip().splitlines()
                 if ln.startswith("{")]
        recs = {r["measure"]: r for r in lines}
        assert os.path.exists(recs["profile"]["trace"])
    assert set(recs) == {"featurize", "fold", "end_to_end", "profile",
                         "seconds"}
    assert recs["featurize"]["cache_dtype"] == "int8"
    assert recs["fold"]["k"] == 128000
    e2e = recs["end_to_end"]
    assert e2e["projected_s"] == pytest.approx(
        e2e["projected_featurize_s"] + e2e["projected_fold_s"])
    assert e2e["gap_s"] == pytest.approx(e2e["measured_s"]
                                         - e2e["projected_s"])
    prof = recs["profile"]
    assert prof["device"] == "cpu" and prof["card"] is None
    assert prof["idle_share"] is None and prof["kernels"] == []
    assert prof["launches_counted"] == {"tap_epilogue": 0, "knn_argmin": 0}


def test_tune_knn_on_the_cpu(capsys):
    assert tune_knn.main(["--device", "cpu", "--n_q", "4", "--s_rows", "12",
                          "--k", "40", "--reps", "1"]) == 0
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    rows = [r for r in lines if "engine" in r]
    assert [(r["engine"], r["dtype"], r["s_block"]) for r in rows] == [
        (e, d, b) for e, d in (("gemm", "float32"), ("pallas", "float32"),
                               ("pallas", "bfloat16"), ("taps-int8", "int8"))
        for b in (2048, 4096, 8192)]
    assert all(r["pairs_per_sec"] > 0 and r["device"] == "cpu"
               for r in rows)
    assert "best" in lines[-1]


@pytest.mark.parametrize("tool", ["profile_attack", "tune_knn"])
def test_card_tools_refuse_without_a_gpu(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"profile_attack": profile_attack.main,
            "tune_knn": tune_knn.main}[tool]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])
