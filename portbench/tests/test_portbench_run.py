"""A run of the harness on the CPU at a tiny size (a cell added as data
only): its last line, its isolation check, its seeds, and its refusal
without a card."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from portbench import run, traffic
from portbench.tests.conftest import TINY, add_cell, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(capsys, root, trace=0, seconds=0.2, seed=2 ** 33 + 5,
         device="cpu", workload=TINY):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], device=device,
                  root=root)
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(capsys, tiny_root, trace):
    rc, out, err = _run(capsys, tiny_root, trace)
    assert rc == 0
    res = json.loads(out.strip().splitlines()[-1])
    assert list(res)[:5] == KEYS and list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    bench = json.load(open(f"{tiny_root}/BENCHMARK.json"))
    kind = "per_layer" if trace else "end_to_end"
    names = {n for n, _ in run.cell_metrics(bench, TINY, kind)}
    # the CPU has no device trace and no peaks: those readers are silent
    assert set(res["metrics"]) <= names
    assert ("setup_s" in res["metrics"]) == (not trace)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    assert res["device"]["platform"] == "cpu"
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["device"]["window_s"] > 0
    lines = err.strip().splitlines()
    assert all(line.startswith("check ") for line in
               lines[-len(res["check"]):])


def test_a_cell_added_as_data_runs(capsys, tiny_root):
    config, workload = tiny_cell()
    workload["traffic"].update(synthetic=40, planted=2)
    add_cell(tiny_root, "tiny-alex-32.smaller", config, workload)
    rc, out, _ = _run(capsys, tiny_root, workload="tiny-alex-32.smaller")
    res = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"pairs_per_s", "setup_s"}


def test_isolation_compares_whole_names(monkeypatch):
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "ganleaks_tpu_torch_extra",
                        types.ModuleType("x"))
    assert run.loaded_forbidden() == []
    for name in ("jax.numpy", "ganleaks_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.loaded_forbidden() == ["flax", "ganleaks_tpu", "jax"]


def _reader_that_loads(root: str, metric: str, module: str) -> None:
    """Make ``metrics/<metric>.py`` put ``module`` into sys.modules."""
    path = f"{root}/portbench/metrics/{metric}.py"
    with open(path, "a") as f:
        f.write(f"\nimport sys as _s, types as _t\n"
                f"_s.modules[{module!r}] = _t.ModuleType({module!r})\n")


@pytest.mark.parametrize("where", ["window", "reader"])
def test_jax_loaded_refuses(capsys, monkeypatch, tiny_root, where):
    """Loaded by the program before the window closed, or by a metric's
    reader after it: either way no result."""
    if where == "window":
        monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    else:
        monkeypatch.delitem(sys.modules, "jaxlib", raising=False)
        monkeypatch.delitem(sys.modules, "jax", raising=False)
        _reader_that_loads(tiny_root, "pairs_per_s", "jax.numpy")
    try:
        rc, out, err = _run(capsys, tiny_root)
    finally:
        sys.modules.pop("jax.numpy", None)
    assert rc != 0 and out == ""
    assert ("jaxlib" if where == "window" else "jax") in err


def test_without_a_card_no_result(capsys, tiny_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, out, _ = _run(capsys, tiny_root, device=None)
    assert rc != 0 and out == ""


def test_seed_gives_the_same_inputs():
    spec = {"members": 3, "non_members": 2, "synthetic": 9, "planted": 2,
            "layout": 8, "pixel_noise": 24, "copy_noise": 8}
    seed = 2 ** 31 + 12345
    pos, neg = traffic.queries(spec, 16, seed, "cpu")
    pos2, neg2 = traffic.queries(spec, 16, seed, "cpu")
    assert np.array_equal(pos, pos2) and np.array_equal(neg, neg2)
    a = traffic.synthetic(spec, 16, seed, 0, pos, "cpu")
    assert torch.equal(a, traffic.synthetic(spec, 16, seed, 0, pos, "cpu"))
    assert not torch.equal(a, traffic.synthetic(spec, 16, seed, 1, pos,
                                                "cpu"))
    assert not torch.equal(a, traffic.synthetic(
        spec, 16, seed, 0, pos, "cpu", traffic.WARMUP))
    # every planted copy lies within copy_noise of a member
    diff = (a.to(torch.int16)[:, None]
            - torch.from_numpy(pos).to(torch.int16)[None]).abs()
    near = diff.flatten(2).max(-1).values <= spec["copy_noise"]
    assert int(near.any(1).sum()) >= spec["planted"]


@pytest.mark.cuda
def test_tiny_cell_on_the_card(capsys, tiny_root, card):
    """The harness on the card at a tiny size, through the recipe the
    configurations state there (int8 parts on a bf16 tower)."""
    add_cell(tiny_root, "tiny-alex-32.card",
             *tiny_cell("taps-int8", "bfloat16", "tiny-alex-32.card"))
    rc, out, err = _run(capsys, tiny_root, trace=1, device=card,
                        workload="tiny-alex-32.card")
    res = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True, err[-2000:]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
    assert "k2.roofline" in res["metrics"]
