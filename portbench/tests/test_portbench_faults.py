"""The comparison fails what it must: the timed path broken underneath a
run (half of the synthetic set left out, the answers altered where they
are produced, the previous call's state returned), and the control, the
reference one precision step below the fold. Each is held under the
alex cell's limits."""

import json

import pytest

from portbench import check, control
from portbench.tests.conftest import TINY, tiny_cell


def _half_set(real):
    def attack(cfg, syn, pos, neg, **kw):
        return real(cfg, syn[:len(syn) // 2], pos, neg, **kw)
    return attack


def _altered(real):
    def attack(cfg, syn, pos, neg, **kw):
        out = real(cfg, syn, pos, neg, **kw)
        for k in ("pos_nn_idx", "neg_nn_idx"):
            out[k] = (out[k] + 1) % len(syn)
        return out
    return attack


def _stale(real):
    held = []

    def attack(cfg, syn, pos, neg, **kw):
        out = real(cfg, syn, pos, neg, **kw)
        held.append(out)
        return held[0]
    return attack


@pytest.mark.parametrize("fault", [None, _half_set, _altered, _stale],
                         ids=["sound", "half_set", "altered", "stale"])
def test_broken_path_is_not_correct(capsys, monkeypatch, tiny_root, fault):
    from ganleaks_tpu_torch.attack import fbb

    from portbench import run
    if fault is not None:
        monkeypatch.setattr(fbb, "attack_arrays", fault(fbb.attack_arrays))
    rc = run.main(["--workload", TINY, "--seed", "20260", "--seconds",
                   "0.3", "--trace", "0"], device="cpu", root=tiny_root)
    out, _ = capsys.readouterr()
    res = json.loads(out.strip().splitlines()[-1])
    assert rc == 0
    assert res["correct"] is (fault is None), res["check"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails(seed):
    config, workload = tiny_cell()
    got = control.control(workload, config, seed, "cpu")
    ok, table = check.verdict(got, workload["check"]["limits"])
    assert not ok, table
