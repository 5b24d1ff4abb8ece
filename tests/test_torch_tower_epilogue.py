"""The LPIPS tower's pass after each convolution
(``ops/lpips/bias_relu.bias_relu_pool``) and the tower's route through it
(``ops/lpips/backbones.Tower``).

On the CPU the pass is its plain version, held here bit for bit against
the PyTorch ops it replaces; the kernel itself is held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
The tower takes the kernel's route only on the card; these tests force
it on the CPU (``backbones._on_kernel``) to hold the route itself: which
convolutions go through the pass, which pools it takes, what the taps
read, that a backward through the tower never takes it, and the counters
a search reports.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ganleaks_tpu_torch.attack.fbb import attack_arrays
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.ops.lpips import backbones, bias_relu
from ganleaks_tpu_torch.ops.lpips import train2afc as tt
from ganleaks_tpu_torch.ops.lpips.bias_relu import (TOWER_COUNTERS,
                                                   bias_relu_pool,
                                                   tower_counts)
from ganleaks_tpu_torch.ops.lpips.lpips import init_lpips_params

NETS = ("vgg", "alex", "squeeze", "resnet")
# ReLU-following convolutions per forward (a fire module's three, a
# residual block's first) and the pools the pass takes
RELU_CONVS = {"vgg": 13, "alex": 5, "squeeze": 25, "resnet": 9}
FUSED_POOLS = {"vgg": 4, "alex": 0, "squeeze": 0, "resnet": 0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of ``t`` in (N, H, W, C) order (NaN payloads and
    signed zeros compared too)."""
    t = t.permute(0, 2, 3, 1).contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


def _conv_output(n, c, h, w, dtype, seed=0):
    """A channels-last (N, C, H, W) tensor with NaN, -0, +0 and values
    the bias cancels exactly, and a bias with signed zeros."""
    g = torch.Generator().manual_seed(seed)
    b = torch.randn(c, generator=g).to(dtype)
    b[::5] = -0.0
    b[1::5] = 0.0
    x = torch.randn((n, h, w, c), generator=g).to(dtype)
    x[:, ::3, ::2] = -b            # x + b == 0 exactly
    flat = x.view(-1)
    flat[::13] = float("nan")
    flat[1::11] = -0.0
    flat[2::7] = 0.0
    return x.permute(0, 3, 1, 2), b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [16, 64, 192, 512])
@pytest.mark.parametrize("h,w", [(8, 8), (7, 9)])
def test_plain_is_the_torch_ops(dtype, c, h, w):
    """The plain version is ``F.relu(x + b)`` and ``F.max_pool2d(y, 2, 2)``
    bit for bit, NaN and signed zeros included; pooled or not, y is the
    same, and an odd last row or column is not pooled."""
    x, b = _conv_output(2, c, h, w, dtype)
    want = F.relu(x + b.view(1, -1, 1, 1))
    want_pool = F.max_pool2d(want, 2, 2)
    y, none = bias_relu_pool(x, b, False)
    y2, pooled = bias_relu_pool(x, b, True)
    assert none is None
    assert pooled.shape == (2, c, h // 2, w // 2)
    assert y.is_contiguous(memory_format=torch.channels_last)
    for got, ref in ((y, want), (y2, want), (pooled, want_pool)):
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert torch.isnan(y).any() and (_bits(y) == 0).any()


def test_refusals():
    """The pass takes channels-last contiguous float32 / bfloat16 with C a
    multiple of 4 / 8 and the bias in that dtype, and pools two rows and
    two columns at least, on every device; the launch itself takes CUDA
    tensors only."""
    ok, b = _conv_output(1, 16, 4, 4, torch.bfloat16)
    bias_relu_pool(ok, b, True)
    bad = [
        (ok.half(), b.half(), "float32 or bfloat16"),
        (ok.contiguous(), b, "channels-last"),
        (ok[:, :8], b[:8], "channels-last"),
        (*_conv_output(1, 12, 4, 4, torch.bfloat16), "multiples of 8"),
        (*_conv_output(1, 6, 4, 4, torch.float32), "multiples of 4"),
        (ok, b.float(), "bias must be"),
        (ok, b[:8], "bias must be"),
    ]
    for x, bias, msg in bad:
        with pytest.raises(ValueError, match=msg):
            bias_relu_pool(x, bias, False)
    for shape in ((1, 16, 1, 4), (1, 16, 5, 1)):  # F.max_pool2d raises too
        x, bias = _conv_output(*shape, torch.float32)
        bias_relu_pool(x, bias, False)
        with pytest.raises(ValueError, match="two rows and two columns"):
            bias_relu_pool(x, bias, True)
    launches = bias_relu_pool.launches
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        bias_relu._launch(ok, b, True)
    assert bias_relu_pool.launches == launches


def _unfused_taps(tower, x):
    """The tower's element list as separate PyTorch ops: every
    ReLU-following convolution with no bias, then ``F.relu(y + b)``; every
    pool ``F.max_pool2d``."""
    def conv(h, c, bias=False):
        return F.conv2d(h, c.weight.to(h.dtype),
                        c.bias.to(h.dtype) if bias else None,
                        stride=c.stride, padding=c.padding)

    def conv_relu(h, c):
        return F.relu(conv(h, c) + c.bias.to(h.dtype).view(1, -1, 1, 1))

    h = x.permute(0, 3, 1, 2)
    convs = iter(tower.convs)
    taps = []
    for el in tower.elems:
        if el[0] == "tap":
            taps.append(h.permute(0, 2, 3, 1))
        elif el[0] == "maxpool":
            k, s, mode = el[1:]
            h = F.max_pool2d(h, k, s, padding=int(mode == "pad1"),
                             ceil_mode=mode == "ceil")
        elif el[0] == "conv":
            h = conv_relu(h, next(convs))
        elif el[0] == "fire":
            sq = conv_relu(h, next(convs))
            h = torch.cat([conv_relu(sq, next(convs)),
                           conv_relu(sq, next(convs))], dim=1)
        else:  # resblock: the second conv and the downsample keep the bias
            y = conv(conv_relu(h, next(convs)), next(convs), bias=True)
            if el[3]:
                h = conv(h, next(convs), bias=True)
            h = F.relu(y + h)
    return taps


@pytest.fixture
def kernel_route(monkeypatch):
    """The tower takes the kernel's route on the CPU too (where autograd
    records nothing), and every call of the pass is recorded as (C,
    pool)."""
    calls = []

    def spy(x, bias, pool):
        calls.append((x.shape[1], pool))
        return bias_relu_pool(x, bias, pool)

    monkeypatch.setattr(backbones, "_on_kernel",
                        lambda h, conv: not backbones._records_grad(h, conv))
    monkeypatch.setattr(backbones, "bias_relu_pool", spy)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("res", [64, 37])
@pytest.mark.parametrize("net", NETS)
def test_tower_route_matches_unfused_ops(kernel_route, net, res, dtype):
    """On the kernel's route the tower's taps equal the unfused sequence
    bit for bit: each ReLU-following convolution goes through the pass
    once, the pass pools exactly where conv, tap, then a 2x2 floor pool
    follow (VGG16's four pools), and every tap is the full-resolution
    post-ReLU tensor; the convolutions are counted on the kernel's
    route."""
    model = init_lpips_params(seed=3, net=net)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, res, res, 3)).astype(np.float32)).to(dtype)
    before = dict(tower_counts)
    with torch.inference_mode():
        got = model.tower(x)
        want = _unfused_taps(model.tower, x)
    assert len(kernel_route) == RELU_CONVS[net]
    assert sum(pool for _, pool in kernel_route) == FUSED_POOLS[net]
    assert [tower_counts[k] - before[k] for k in TOWER_COUNTERS] == \
        [RELU_CONVS[net], 0]
    assert len(got) == len(want) == len(backbones.backbone_channels(net))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(_bits(g.permute(0, 3, 1, 2)),
                                      _bits(w.permute(0, 3, 1, 2)))


def test_cpu_route_takes_the_plain_ops():
    """Off the card the tower keeps its PyTorch ops (the bias inside
    ``F.conv2d``) and counts every ReLU-following convolution as plain."""
    model = init_lpips_params(seed=3, net="squeeze")
    x = torch.zeros((1, 32, 32, 3))
    before = dict(tower_counts)
    with torch.inference_mode():
        model.tower(x)
    assert [tower_counts[k] - before[k] for k in TOWER_COUNTERS] == \
        [0, RELU_CONVS["squeeze"]]


def _step(tune: bool, net: str = "squeeze", res: int = 32):
    """One lr-0 ``train2afc`` step from fixed weights, batch and masks;
    returns the loss and every gradient it left."""
    model = init_lpips_params(seed=2, net=net)
    rank = tt.Dist2Logit(seed=2)
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.uniform(-1, 1, (3, res, res, 3))
                                 .astype(np.float32))
             for k in ("ref", "p0", "p1")}
    batch["judge"] = torch.from_numpy(rng.uniform(0, 1, 3)
                                      .astype(np.float32))
    g = torch.Generator().manual_seed(4)
    keep0 = tt.dropout_masks(model, batch["ref"].shape, g, "cpu")
    keep1 = tt.dropout_masks(model, batch["ref"].shape, g, "cpu")
    step, _ = tt.make_2afc_step(model, rank, tune_backbone=tune)
    loss, _, _ = step(batch, 0.0, keep0, keep1)
    params = list(model.lins) + list(rank.parameters()) \
        + list(model.tower.parameters())
    return loss, [p.grad for p in params]


def test_backward_through_the_tower_takes_no_kernel(monkeypatch):
    """``train2afc`` with ``tune_backbone`` records the tower for its
    backward: on the kernel's route it still runs the PyTorch ops (the
    pass is never called), with the same loss and gradients bit for bit.
    Training the lin heads alone records nothing in the tower, which then
    takes the pass."""
    want_loss, want_grads = _step(tune=True)
    calls = []
    real = backbones.bias_relu_pool

    def spy(x, bias, pool):
        calls.append(pool)
        return real(x, bias, pool)

    monkeypatch.setattr(backbones, "_on_kernel",
                        lambda h, conv: not backbones._records_grad(h, conv))
    monkeypatch.setattr(backbones, "bias_relu_pool", spy)
    before = dict(tower_counts)
    loss, grads = _step(tune=True)
    assert calls == []
    assert tower_counts[TOWER_COUNTERS[0]] == before[TOWER_COUNTERS[0]]
    # two forwards of the tower a pair, two pairs
    assert tower_counts[TOWER_COUNTERS[1]] - before[TOWER_COUNTERS[1]] == \
        4 * RELU_CONVS["squeeze"]
    assert torch.equal(loss, want_loss)
    assert all(g is not None for g in grads)
    for g, w in zip(grads, want_grads):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    _step(tune=False)
    assert len(calls) == 4 * RELU_CONVS["squeeze"]


def _sets(res, n_syn=20, n_q=6, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, res, res, 3), np.uint8)
                 for n in (n_syn, n_q // 2, n_q - n_q // 2))


@pytest.mark.parametrize("route", ["cpu", "kernel"])
@pytest.mark.parametrize("engine", ["gemm", "taps-int8"])
def test_counters_through_attack_arrays(request, route, engine):
    """``attack_arrays`` reports the tower's ReLU-following convolutions
    of every featurised block (query blocks, then the synthetic blocks),
    13 a block for VGG16, under the route they took; with a held query
    cache only the synthetic blocks count. Without LPIPS both read 0."""
    if route == "kernel":
        request.getfixturevalue("kernel_route")
    syn, pos, neg = _sets(32)
    cfg = AttackConfig(distance="l2-lpips", resolution=32, engine=engine,
                       dtype="bfloat16", lpips_compute_dtype="bfloat16",
                       query_block=4, syn_block=8, save_plots=False)
    cache: dict = {}
    first = attack_arrays(cfg, syn, pos, neg, device="cpu",
                          sweep_cache=cache)["counters"]
    second = attack_arrays(cfg, syn, pos, neg, device="cpu",
                           sweep_cache=cache)["counters"]
    q_blocks, s_blocks = 2, 3
    on, off = TOWER_COUNTERS if route == "kernel" else TOWER_COUNTERS[::-1]
    assert (first[on], first[off]) == (13 * (q_blocks + s_blocks), 0)
    assert (second[on], second[off]) == (13 * s_blocks, 0)
    l2 = attack_arrays(AttackConfig(distance="l2", resolution=32,
                                    engine=engine, query_block=4,
                                    syn_block=8, save_plots=False),
                       syn, pos, neg, device="cpu")["counters"]
    assert [l2[k] for k in TOWER_COUNTERS] == [0, 0]
