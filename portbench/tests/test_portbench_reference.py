"""The plain reference: its embedding identity, its float32 against
float64, and the weights the program receives through the npz."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import nets, reference, traffic, weights
from portbench.tests.conftest import tiny_cell

SPEC = {"layout": 8, "pixel_noise": 24}


def _setup(net="alex", res=32, n=6, seed=3):
    config = {"net": net, "resolution": res,
              "lin_heads": {"low": 0.0, "high": 0.2}}
    w = weights.make(config, seed, "cpu")
    gen = traffic.generator(seed, "cpu", 9)
    return w, traffic.draw_images(gen, n, res, SPEC, "cpu")


def _pairwise(x8, y8, w, net):
    """mean((x - y)^2) + 0.2 * LPIPS(x, y) directly, in float64."""
    def feats(b):
        x = b.double() * (2.0 / 255.0) - 1.0
        h = ((x - torch.tensor(nets.SHIFT, dtype=torch.float64))
             / torch.tensor(nets.SCALE, dtype=torch.float64)).permute(
                 0, 3, 1, 2)
        out, convs = [], iter(w["convs"])
        for layer in nets.layers(net):
            if layer[0] == "conv":
                k, b_ = next(convs)
                h = F.relu(F.conv2d(h, k.double(), b_.double(),
                                    stride=layer[3], padding=layer[4]))
            elif layer[0] == "pool":
                h = F.max_pool2d(h, layer[1], layer[2])
            else:
                f = h.permute(0, 2, 3, 1)
                out.append(f / (f.norm(dim=-1, keepdim=True) + nets.EPS))
        return x, out
    x, fx = feats(x8)
    y, fy = feats(y8)
    lp = sum(((a - b) ** 2 * lin.double()).sum(-1).mean((1, 2))
             for a, b, lin in zip(fx, fy, w["lins"]))
    return ((x - y) ** 2).mean((1, 2, 3)) + 0.2 * lp


def test_embedding_distance_is_the_published_distance():
    w, imgs = _setup()
    e = reference.embed(imgs, w, "alex", torch.float64)
    d = ((e[:3] - e[3:]) ** 2).sum(1)
    assert torch.allclose(d, _pairwise(imgs[:3], imgs[3:], w, "alex"),
                          rtol=1e-10)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_float32_against_float64(net):
    w, imgs = _setup(net)
    e32 = reference.embed(imgs, w, net).double()
    e64 = reference.embed(imgs, w, net, torch.float64)
    d32 = ((e32[:, None] - e32[None]) ** 2).sum(-1)
    d64 = ((e64[:, None] - e64[None]) ** 2).sum(-1)
    assert (d32 - d64).abs().max() <= 1e-5 * d64.max()


def test_program_reads_the_same_weights(tmp_path):
    """The npz hands the program the reference's weights: its float32
    featuriser's distances agree with the reference's."""
    from ganleaks_tpu_torch.attack.fbb import build_embed_fn
    from ganleaks_tpu_torch.config import AttackConfig

    config, _ = tiny_cell()
    w, imgs = _setup()
    path = str(tmp_path / "w.npz")
    weights.save_npz(w, "alex", path)
    cfg = AttackConfig(**config["attack"], lpips_weights=path)
    mine = build_embed_fn(cfg, "cpu")(imgs).double()
    ref = reference.embed(imgs, w, "alex").double()
    d_m = ((mine[:, None] - mine[None]) ** 2).sum(-1)
    d_r = ((ref[:, None] - ref[None]) ** 2).sum(-1)
    assert (d_m - d_r).abs().max() <= 1e-5 * d_r.max()


def test_quantized_parts_stay_in_their_bounds():
    w, imgs = _setup()
    e = reference.embed(imgs, w, "alex", torch.float64)
    widths = reference.part_widths("alex", 32)
    bounds = reference.part_bounds(w["lins"], "alex", 32)
    assert sum(widths) == e.shape[1]
    off = 0
    for wd, a in zip(widths, bounds):
        assert e[:, off:off + wd].abs().max() <= a * (1 + 1e-12)
        off += wd
    q = reference.quantize(e, widths, bounds, 7)
    assert q.abs().max() <= 7 and torch.equal(q, q.round())
    exact = reference.quantized_cross(q, q, widths, bounds, 7)
    assert exact.shape == (6, 6) and np.isfinite(exact.numpy()).all()
