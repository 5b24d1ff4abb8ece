"""Every configuration, cell and metric of ``BENCHMARK.json`` is found by
name among the benchmark's files, and the file keeps the contract's
shape."""

import json
import os
import re

import pytest

from portbench import run
from portbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILE = re.compile(r"^[A-Za-z0-9_./-]+$")

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
E2E = {m["name"] for m in BENCH["end_to_end"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) < 64 * 1024
    assert "setup_s" in E2E
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    with open(os.path.join(REPO, entry["file"])) as f:
        config = json.load(f)
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    module = run.config_module(config, REPO)
    assert callable(module.Bench) and callable(module.least_seconds)


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_file(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1 and 1 <= len(entry["why"]) <= 200
    _bench, workload, config = run.load_cell(entry["name"], REPO)
    assert workload["config"] == entry["config"] == config["name"]
    assert workload["chips"] == entry["chips"]
    assert workload["traffic_name"] == entry["traffic"]
    assert set(workload["check"]["limits"]) == {"loss_gap", "nn_gap"}
    e2e = run.cell_metrics(BENCH, entry["name"], "end_to_end")
    assert "setup_s" in dict(e2e) and len(e2e) >= 2
    assert run.cell_metrics(BENCH, entry["name"], "per_layer")


@pytest.mark.parametrize("entry", METRICS, ids=lambda e: e["name"])
def test_metric_reader(entry):
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    assert callable(run.reader(entry["name"], REPO))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry.get("workloads", cells)) <= cells
    if entry["name"] in E2E:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    else:
        assert entry["moves"] in E2E and "\n" not in entry["layer"]


def _names(folder: str) -> list[str]:
    here = os.path.join(REPO, "portbench", folder)
    return sorted(os.path.splitext(f)[0] for f in os.listdir(here)
                  if f.endswith((".json", ".py")) and not f.startswith("_"))


@pytest.mark.parametrize("name", _names("workloads"))
def test_every_workload_file_loads(name):
    """Cells held out of ``BENCHMARK.json`` stay loadable as data."""
    _bench, workload, config = run.load_cell(name, REPO)
    assert workload["config"] == config["name"]
    assert set(workload["check"]["limits"]) == {"loss_gap", "nn_gap"}
    assert config["net"] in ("vgg", "alex")


@pytest.mark.parametrize("name", _names("metrics"))
def test_every_metric_file_loads(name):
    assert callable(run.reader(name, REPO))


@pytest.mark.parametrize("name", _names("modules"))
def test_every_module_file_loads(name):
    module = run.config_module({"module": name}, REPO)
    assert callable(module.Bench) and callable(module.least_seconds)
    assert module.Bench.COUNTS


def test_files_are_named_from_name_characters():
    here = os.path.join(REPO, "portbench")
    for base, dirs, files in os.walk(here):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            rel = os.path.relpath(os.path.join(base, name), REPO)
            assert FILE.match(rel), rel
