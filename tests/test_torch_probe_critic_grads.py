"""``ganleaks_tpu_torch.tools.probe_critic_grads`` on the CPU at batch 2,
one draw: every leaf layer of the DCGAN discriminator and the WGAN-GP
critic gets its input gradient's error, float32 against float64.

DCGAN's float32 gradients at every layer's input read ~1.2e-6 off
float64 here: held to 1e-4. The head's input gradient of WGAN-GP's loss
(-mean of the scores) is 1/B whatever the precision: held to 1e-6. The
refusal without a GPU is the entry points' rule."""

import json

import numpy as np
import pytest
import torch

from ganleaks_tpu_torch.tools import probe_critic_grads

LEAVES = ["disc.0", "disc.1"] + [f"disc.{i}.{j}" for i in (2, 3, 4)
                                 for j in range(3)] + ["disc.5"]


@pytest.fixture(scope="module")
def records():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield probe_critic_grads.main(
            ["--device", "cpu", "--batch", "2", "--steps", "1"])
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("kind", probe_critic_grads.KINDS)
def test_every_layer_is_read(records, kind):
    rec = {r["victim"]: r for r in records}[kind]
    assert rec["device"] == "cpu" and rec["batch"] == 2
    assert sorted(rec["input_grad"]) == sorted(LEAVES)
    errs = [v["f32"] for v in rec["input_grad"].values()]
    assert all(np.isfinite(e) and e >= 0 for e in errs)
    json.dumps(rec)


def test_float32_tracks_float64(records):
    rec = {r["victim"]: r for r in records}
    assert max(v["f32"] for v in rec["dcgan"]["input_grad"].values()) < 1e-4
    assert rec["wgangp"]["input_grad"]["disc.5"]["f32"] < 1e-6


def test_refuses_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_critic_grads.main(["--steps", "1"])
