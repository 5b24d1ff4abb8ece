"""The port's benchmark (``ganleaks_tpu_torch.bench``): its defaults are
root ``bench.py``'s (imported here only, never by the port), a ``--quick``
run on the CPU prints one JSON line with the four keys, and without a GPU
it refuses unless asked for the CPU."""

import importlib.util
import json
import pathlib

import pytest
import torch

from ganleaks_tpu_torch import bench

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def root_bench():
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [
    dict(quick=False, n_q=None, n_syn=None, q_block=None, s_block=None,
         cache_gb=None, store=None, two_pass=False, dtype="bfloat16"),
    dict(quick=True, n_q=None, n_syn=None, q_block=None, s_block=None,
         cache_gb=None, store=None, two_pass=False, dtype="bfloat16"),
    dict(quick=False, n_q=2000, n_syn=None, q_block=None, s_block=None,
         cache_gb=None, store=None, two_pass=False, dtype="bfloat16"),
    dict(quick=False, n_q=None, n_syn=50000, q_block=None, s_block=None,
         cache_gb=None, store=None, two_pass=False, dtype="bfloat16"),
    dict(quick=False, n_q=None, n_syn=None, q_block=None, s_block=None,
         cache_gb=None, store=None, two_pass=True, dtype="bfloat16"),
    dict(quick=False, n_q=None, n_syn=None, q_block=None, s_block=None,
         cache_gb=None, store=None, two_pass=False, dtype="float32"),
    dict(quick=False, n_q=None, n_syn=None, q_block=1024, s_block=512,
         cache_gb=4.0, store="float32", two_pass=False, dtype="bfloat16"),
    dict(quick=True, n_q=4, n_syn=8, q_block=None, s_block=None,
         cache_gb=2.0, store="uint8", two_pass=True, dtype="float32"),
])
def test_resolve_defaults_equals_root_bench(root_bench, kw):
    assert bench.resolve_defaults(**kw) == root_bench.resolve_defaults(**kw)


def test_north_star_is_the_default():
    assert bench.resolve_defaults(
        quick=False, n_q=None, n_syn=None, q_block=None, s_block=None,
        cache_gb=None, store=None, two_pass=False, dtype="bfloat16") \
        == (20000, 100000, 2048, 2048, 10.0, "uint8")
    assert bench.REFERENCE_CPU_PAIRS_PER_SEC == 15.0


def test_quick_run_on_the_cpu_prints_one_json_line(capsys):
    assert bench.main(["--quick", "--n_q", "4", "--n_syn", "8"],
                      device="cpu") == 0
    captured = capsys.readouterr()
    lines = [ln for ln in captured.out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["unit"] == "query-pairs/sec" and rec["value"] > 0
    assert "(cpu, taps-int8, 4x8 @64x64)" in rec["metric"]
    assert rec["vs_baseline"] == round(rec["value"] / 15.0, 1)
    detail = json.loads(captured.err.strip().splitlines()[-1])["detail"]
    assert detail["oom_resumes"] == 0 and detail["plan"]["sweeps"] == 1


def test_refuses_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--quick"])
