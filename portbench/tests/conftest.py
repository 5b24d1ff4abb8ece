"""Fixtures of the benchmark's tests: a card where one is present, and a
checkout copy holding one more cell, added as data only.

Tests that need a CUDA card carry the ``cuda`` marker and skip inside the
``card`` fixture; whether a card is present is never decided while a
module is imported.
"""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = "tiny-alex-32.cpu"


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def add_cell(root: str, name: str, config: dict, workload: dict) -> None:
    """A cell added as files: its configuration, its workload and its
    name in every metric's cell list."""
    here = os.path.join(root, "portbench")
    with open(os.path.join(here, "configs", f"{config['name']}.json"),
              "w") as f:
        json.dump(config, f)
    with open(os.path.join(here, "workloads", f"{name}.json"), "w") as f:
        json.dump(workload, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(bench, f)


def tiny_cell(engine: str = "gemm", embed_dtype: str = "float32",
              name: str = "tiny-alex-32"):
    """AlexNet at 32 px: 8 + 8 queries x 64 synthetic images, 6 planted,
    compared under the limits of the alex cell; ``engine`` and
    ``embed_dtype`` are what the program must resolve to (on the CPU its
    float32 'gemm')."""
    here = os.path.join(REPO, "portbench")
    with open(os.path.join(here, "configs", "lpips-alex-64.json")) as f:
        config = json.load(f)
    with open(os.path.join(here, "workloads", "alex-64.privgan.json")) as f:
        workload = json.load(f)
    config.update(name=name, resolution=32, engine_resolved=engine,
                  embed_dtype=embed_dtype)
    config["attack"]["resolution"] = 32
    workload["config"] = name
    workload["traffic"].update(members=8, non_members=8, synthetic=64,
                               planted=6)
    workload["check"].update(calls=2, queries=16, block=32)
    return config, workload


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark's files with the tiny cell added."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    add_cell(root, TINY, *tiny_cell())
    return root
