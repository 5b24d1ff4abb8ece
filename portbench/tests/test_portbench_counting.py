"""The yardstick's counts, held against the published sizes and against
the program's own towers."""

import pytest
import torch

from portbench import counting, nets


def test_vgg16_at_64px():
    assert counting.tower_macs("vgg", 64) == 1_252_786_176  # 1.2527e9
    assert counting.embed_dim("vgg", 64) == 512_000


def test_alexnet_k_from_its_taps():
    taps = nets.tap_shapes("alex", 64)
    assert [h * w * c for h, w, c in taps] == [14_400, 9_408, 3_456,
                                               2_304, 2_304]
    assert counting.embed_dim("alex", 64) == 44_160


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_counts_match_the_program_tower(net, monkeypatch):
    from ganleaks_tpu_torch.ops.lpips.backbones import Tower

    tower = Tower(net)
    macs = []
    conv2d = torch.nn.functional.conv2d

    def count(x, w, *args, **kwargs):
        out = conv2d(x, w, *args, **kwargs)
        o, c, k, _ = w.shape
        macs.append(out.shape[2] * out.shape[3] * o * c * k * k)
        return out

    monkeypatch.setattr(torch.nn.functional, "conv2d", count)
    with torch.no_grad():
        taps = tower(torch.zeros(1, 64, 64, 3))
    assert [tuple(t.shape[1:]) for t in taps] == nets.tap_shapes(net, 64)
    assert sum(macs) == counting.tower_macs(net, 64)


def test_k2_and_fold_counts():
    # a 2,048-image block of VGG16 taps, bf16 in and int8 out: ~3.07 GB
    assert counting.k2_bytes("vgg", 64, 2048, "bfloat16", "int8") == \
        pytest.approx(3.07e9, rel=2e-3)
    assert counting.fold_ops(20_000, 100_000, 512_000) == 2.048e15
    t = counting.least_seconds(2.048e15, "int8", 6.2e10,
                               "NVIDIA H100 80GB HBM3")
    assert t == pytest.approx(2.048e15 / 1979e12)
    assert counting.least_seconds(1.0, "int8", 1.0, "another card") is None
