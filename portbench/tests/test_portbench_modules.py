"""Configuration modules: the default one makes today's inputs and
compares as the plain arithmetic says, and a configuration that brings
its own module (a DCGAN victim sampled inside each call, with its own
plain reference) runs through the harness as files only, ``correct``
when right and not when its picks are shifted by one."""

import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from portbench import reference, run, traffic
from portbench.tests.conftest import REPO, add_cell, tiny_cell

SEEDS = [5, 2 ** 31 + 77, 2 ** 33 + 5]
HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLED = "tiny-dcgan-32.sampled"
# a per-layer metric added as a file: one counter and one span
METRIC = "attack.reused_rows_per_s"
READER = '''
def read(r):
    t = r["trace"]
    secs = 0.0 if t is None else t["spans"].get("fbb.attack_arrays", 0.0)
    rows = sum(c["counters"]["query_rows_reused"] for c in r["calls"]
               if c["ok"])
    return rows / secs if secs > 0 else None
'''


def _bench(seed, tmp, cell=None):
    config, workload = cell or tiny_cell()
    module = run.config_module(config, REPO)
    return module.Bench(config, workload, seed, "cpu", tmp)


@pytest.mark.parametrize("seed", SEEDS)
def test_default_inputs_are_the_generators(seed, tmp_path):
    """The warm-up's set and the first two window calls' sets, and their
    checksums, bit for bit those of ``traffic.synthetic``."""
    config, workload = tiny_cell()
    spec, res = workload["traffic"], config["resolution"]
    bench = _bench(seed, str(tmp_path))
    pos, neg = traffic.queries(spec, res, seed, "cpu")
    assert np.array_equal(bench.pos, pos) and np.array_equal(bench.neg, neg)
    for call, stream in ((0, traffic.WARMUP), (0, traffic.WINDOW),
                         (1, traffic.WINDOW)):
        host, total = bench.call_input(call, stream)
        want = traffic.synthetic(spec, res, seed, call, pos, "cpu", stream)
        assert host.dtype == np.uint8
        assert np.array_equal(host, want.numpy())
        assert total == traffic.checksum(want)


def test_default_comparison_is_the_plain_arithmetic(tmp_path):
    """One call's results replayed through ``Bench.compare``: its numbers
    are those of every distance taken at once in float64."""
    seed = 2 ** 32 + 3
    config, workload = tiny_cell()
    bench = _bench(seed, str(tmp_path))
    syn, total = bench.call_input(0, traffic.WINDOW)
    answers = bench.answers(bench.timed_call(syn, None))
    qs = np.array([0, 3, 5, 8, 11, 15])
    got = bench.compare(0, answers, qs, total)

    queries = np.concatenate([bench.pos, bench.neg])[qs]
    eq = reference.embed(torch.from_numpy(queries), bench.weights,
                         "alex").double()
    es = reference.embed(torch.from_numpy(syn), bench.weights,
                         "alex").double()
    rq, rs = (eq * eq).sum(1), (es * es).sum(1)
    d = rq[:, None] + rs[None] - 2.0 * eq @ es.T
    pick = torch.from_numpy(answers["idx"][qs].astype(np.int64))
    d_pick = d.gather(1, pick[:, None]).squeeze(1)
    n = rq + rs[pick]
    loss = torch.from_numpy(answers["loss"][qs])
    assert got["bad_indices"] == 0 and got["set_mismatch"] == 0
    assert got["loss_gap"] == pytest.approx(
        float(((loss - d_pick).abs() / n).max()), rel=1e-9, abs=1e-15)
    assert got["nn_gap"] == pytest.approx(
        float(((d_pick - d.min(1).values) / n).max()), rel=1e-9, abs=1e-15)
    assert got["loss_gap"] <= workload["check"]["limits"]["loss_gap"]

    off = dict(answers, idx=answers["idx"] + len(syn))
    bad = bench.compare(0, off, qs, total + 1)
    assert bad["bad_indices"] == len(qs) and bad["set_mismatch"] == 1


def sampled_cell():
    """The tiny alex cell on a 64-image set sampled from a DCGAN at 32 px
    (nz 16, ngf 4) each call."""
    config, workload = tiny_cell(name="tiny-dcgan-32")
    config.update(module="dcgan_sampled",
                  generator={"nz": 16, "ngf": 4, "batch": 24})
    workload["traffic_name"] = "sampled"
    return config, workload


@pytest.fixture
def sampled_root(tiny_root):
    """The checkout copy with the sampled cell, its module and a metric
    added as files; no file of the harness edited."""
    harness = {f: open(os.path.join(tiny_root, "portbench", f)).read()
               for f in os.listdir(os.path.join(tiny_root, "portbench"))
               if f.endswith(".py")}
    shutil.copy(os.path.join(HERE, "dcgan_sampled.py"),
                os.path.join(tiny_root, "portbench", "modules"))
    add_cell(tiny_root, SAMPLED, *sampled_cell())
    with open(os.path.join(tiny_root, "portbench", "metrics",
                           f"{METRIC}.py"), "w") as f:
        f.write(READER)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": METRIC, "unit": "rows/s", "better": "higher",
        "source": "program_counter", "layer": "query cache",
        "moves": "pairs_per_s", "workloads": [SAMPLED]})
    with open(path, "w") as f:
        json.dump(bench, f)
    for f, text in harness.items():
        assert open(os.path.join(tiny_root, "portbench", f)).read() == text
    return tiny_root


def _run(capsys, root, trace):
    rc = run.main(["--workload", SAMPLED, "--seed", str(2 ** 32 + 11),
                   "--seconds", "0.3", "--trace", str(trace)], device="cpu",
                  root=root)
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_a_module_added_as_files_runs(capsys, sampled_root, trace):
    res = _run(capsys, sampled_root, trace)
    assert res["correct"] is True, res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    if trace:
        assert res["metrics"][METRIC]["value"] > 0
        assert res["metrics"][METRIC]["unit"] == "rows/s"
    else:
        assert set(res["metrics"]) == {"pairs_per_s", "setup_s"}


def test_a_module_with_shifted_picks_is_not_correct(capsys, monkeypatch,
                                                    sampled_root):
    from ganleaks_tpu_torch.attack import fbb

    real = fbb.attack_arrays

    def shifted(cfg, syn, pos, neg, **kw):
        out = real(cfg, syn, pos, neg, **kw)
        for k in ("pos_nn_idx", "neg_nn_idx"):
            out[k] = (out[k] + 1) % len(syn)
        return out

    monkeypatch.setattr(fbb, "attack_arrays", shifted)
    res = _run(capsys, sampled_root, 0)
    assert res["correct"] is False
    assert res["check"]["nn_gap"]["value"] > res["check"]["nn_gap"]["limit"]


def test_the_sampled_reference_is_the_programs_generator():
    """The module's plain forward against the program's generator on the
    same weights, and its whole-call count above the default module's."""
    import importlib.util

    from ganleaks_tpu_torch.models.dcgan import Generator

    spec = importlib.util.spec_from_file_location(
        "dcgan_sampled", os.path.join(HERE, "dcgan_sampled.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    layers = mod.make_generator({"nz": 16, "ngf": 4}, 32, 9, "cpu")
    gen = Generator(nz=16, ngf=4, image_size=32).eval()
    gen.load_state_dict(mod.state_dict(layers))
    z = torch.randn(6, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ((gen(z) + 1.0) / 2.0).clamp(0.0, 1.0)
    got = mod.plain_forward(layers, z)
    assert (got - want).abs().max() <= 1e-5
    assert got.std() > 0.05  # images that differ, so picks can be wrong

    config, _ = sampled_cell()
    call = {"n_q": 16, "n_s": 64, "query_reused": True}
    peaks = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12}
    base = run.config_module(tiny_cell()[0], REPO).least_seconds
    assert mod.least_seconds(config, call, peaks) > base(config, call, peaks)
