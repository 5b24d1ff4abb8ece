"""Tests of the port that need a CUDA device: the fused distance+argmin
and distance+top-k kernels, the tap epilogue kernel and the LPIPS tower's
pass after each convolution against their plain PyTorch versions on the
card, and the searches and engines that
launch them; the distance+argmin kernel on the tabular path's binary rows
(K = 1,071) against float64; the InceptionV3 tower and the spectral-norm
layer on the card against the CPU. They skip without a GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: |d_kernel - d_plain| <= 1e-5 * (rq + rs) — the two sum the K
products in different orders and rq + rs - 2 q.s cancels; indices must be
equal wherever the plain version's neighbouring distances are further
apart than that, and on planted exact ties. The tap epilogue's parts must
be equal bit for bit, its row norms within rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from ganleaks_tpu_torch.ops.knn import knn_argmin_streamed
from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                              knn_argmin_plain,
                                              knn_topk_fused, knn_topk_plain,
                                              sq_norms)
from ganleaks_tpu_torch.ops.lpips.epilogue import (tap_epilogue,
                                                   tap_epilogue_plain)

TOL = 1e-5


def launched_on(fn, dtype, before):
    """``fn`` launched exactly once since ``before`` (a copy of its
    ``launches_by_route``), on the tile of ``dtype``: 3xTF32 for float32,
    wgmma for bfloat16."""
    want = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    got = {r: n - before[r] for r, n in fn.launches_by_route.items()}
    return got == {r: int(r == want) for r in got}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from ganleaks_tpu_torch.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n_s,k", [(300, 1000, 1000), (70, 50, 4099),
                                       (40, 300, 5), (40, 300, 7),
                                       (130, 200, 129)])
def test_kernel_matches_plain(cuda_device, dtype, n_q, n_s, k):
    """K not a multiple of 8 (5, 7, 129, 4099): the bf16 route runs the
    wgmma tile on a zero-padded copy."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((n_q, k), generator=gen, device=cuda_device)
    s = torch.randn((n_s, k), generator=gen, device=cuda_device)
    s[n_s - 1] = s[10] = q[3] + 0.1  # exact tie, lower index must win
    q, s = q.to(dtype), s.to(dtype)
    rq, rs = sq_norms(q), sq_norms(s)
    before = knn_argmin_fused.launches
    by_route = dict(knn_argmin_fused.launches_by_route)
    d, i = knn_argmin_fused(q, s, rq=rq, rs=rs)
    torch.cuda.synchronize()
    assert knn_argmin_fused.launches == before + 1
    assert launched_on(knn_argmin_fused, dtype, by_route)
    d_p, i_p = knn_argmin_plain(q, s, rq, rs)
    tol = TOL * (rq + rs[i_p.long()])
    assert bool(((d - d_p).abs() <= tol).all())
    full = rq[:, None] + rs[None, :] - 2.0 * (q.float() @ s.float().T)
    top2 = torch.topk(full, 2, dim=1, largest=False).values
    clear = (top2[:, 1] - top2[:, 0]) > tol
    assert bool((i[clear] == i_p[clear]).all())
    assert int(i[3]) == int(i_p[3]) == 10


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous(cuda_device):
    q = torch.zeros((8, 16), device=cuda_device)
    s = torch.zeros((16, 8), device=cuda_device).T
    with pytest.raises(ValueError, match="contiguous"):
        knn_argmin_fused(q, s)


@pytest.mark.cuda
def test_streamed_pallas_engine_launches_kernel(cuda_device):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((40, 256)).astype(np.float32)
    s = rng.standard_normal((300, 256)).astype(np.float32)
    s[7] = s[250] = q[3] + 0.05
    before = knn_argmin_fused.launches
    d_k, i_k = knn_argmin_streamed(lambda x: x, q, s, engine="pallas",
                                   q_block=16, s_block=128,
                                   device=cuda_device)
    assert knn_argmin_fused.launches == before + 3  # 300 = 2*128 + 44
    d_g, i_g = knn_argmin_streamed(lambda x: x, q, s, engine="gemm",
                                   q_block=16, s_block=128,
                                   device=cuda_device)
    assert int(i_k[3]) == int(i_g[3]) == 7
    torch.testing.assert_close(i_k, i_g, rtol=0, atol=0)
    torch.testing.assert_close(d_k, d_g, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n_s,k_dim,k", [(300, 1000, 1000, 4),
                                             (70, 50, 4099, 8),
                                             (9, 3, 64, 5),
                                             (40, 300, 7, 3),
                                             (150, 700, 256, 128)])
def test_topk_kernel_matches_plain(cuda_device, dtype, n_q, n_s, k_dim, k):
    """Odd K (the bf16 route's padded copy) and k = 128, the wrapper's
    limit (the wgmma ring at 3 stages beside the lists)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((n_q, k_dim), generator=gen, device=cuda_device)
    s = torch.randn((n_s, k_dim), generator=gen, device=cuda_device)
    s[n_s - 1] = s[1] = q[3] + 0.1  # exact tie, lower index first
    q, s = q.to(dtype), s.to(dtype)
    rq, rs = sq_norms(q), sq_norms(s)
    before = knn_topk_fused.launches
    by_route = dict(knn_topk_fused.launches_by_route)
    d, i = knn_topk_fused(q, s, k, rq=rq, rs=rs)
    torch.cuda.synchronize()
    assert knn_topk_fused.launches == before + 1
    assert launched_on(knn_topk_fused, dtype, by_route)
    d_p, i_p = knn_topk_plain(q, s, k, rq, rs)
    fin = torch.isfinite(d_p)
    assert bool((torch.isfinite(d) == fin).all())
    assert bool((i[~fin] == -1).all())
    tol = (TOL * (rq[:, None] + rs.max())).expand_as(d)
    assert bool(((d - d_p).abs()[fin] <= tol[fin]).all())
    full = rq[:, None] + rs[None, :] - 2.0 * (q.float() @ s.float().T)
    srt = torch.sort(full, dim=1).values
    inf = torch.full_like(srt[:, :1], torch.inf)
    ext = torch.cat([-inf, srt, inf], dim=1)
    for j in range(min(k, n_s)):
        clear = ((ext[:, j + 1] - ext[:, j] > tol[:, 0])
                 & (ext[:, j + 2] - ext[:, j + 1] > tol[:, 0]))
        assert bool((i[clear, j] == i_p[clear, j]).all())
    assert i[3, :2].tolist() == [1, n_s - 1]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_tap_epilogue_kernel_matches_plain(cuda_device, mode):
    """Taps as the tower gives them (channels-last permute views)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    for c, hw in ((64, 16), (128, 8), (512, 2), (96, 3)):
        nchw = torch.relu(torch.randn((5, c, hw, hw), generator=gen,
                                      device=cuda_device)).to(dt)
        tap = nchw.permute(0, 2, 3, 1)
        scale = torch.rand((c,), generator=gen, device=cuda_device) * 0.05
        kw = dict(embed_dtype=dt,
                  out_dtype=torch.float32 if mode == "f32" else dt,
                  quant_bound=0.05 if mode == "int8" else None)
        before = tap_epilogue.launches
        part, rn = tap_epilogue(tap, scale, **kw)
        torch.cuda.synchronize()
        assert tap_epilogue.launches == before + 1
        want, rn_want = tap_epilogue_plain(tap, scale, **kw)
        assert part.dtype == want.dtype
        assert bool((part == want).all()), (c, mode)
        torch.testing.assert_close(rn, rn_want, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_taps_engines_and_auto_launch_kernels(cuda_device, tmp_path):
    import json

    from ganleaks_tpu_torch.attack.fbb import attack_arrays
    from ganleaks_tpu_torch.config import AttackConfig
    from ganleaks_tpu_torch.utils.logging import MetricsLogger

    rng = np.random.default_rng(0)
    syn = rng.integers(0, 256, (40, 32, 32, 3), dtype=np.uint8)
    pos = syn[:6].copy()
    neg = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    base = dict(resolution=32, query_block=32, syn_block=16,
                save_plots=False)
    for engine, two_pass in (("taps", False), ("taps-int8", True),
                             ("pallas", True), ("auto", False)):
        counts = (tap_epilogue.launches, knn_topk_fused.launches,
                  knn_argmin_fused.launches)
        log = str(tmp_path / f"{engine}-{two_pass}.jsonl")
        logger = MetricsLogger(log, echo=False)
        out = attack_arrays(AttackConfig(engine=engine, two_pass=two_pass,
                                         **base), syn, pos, neg,
                            device=cuda_device, logger=logger)
        assert out["pos_nn_idx"].tolist() == list(range(6))
        k2, k3, k1 = (tap_epilogue.launches - counts[0],
                      knn_topk_fused.launches - counts[1],
                      knn_argmin_fused.launches - counts[2])
        if engine.startswith("taps") or engine == "auto":
            assert k2 > 0
        if two_pass:
            assert k3 > 0 or engine == "taps-int8"
            assert k1 > 0  # the float32 re-rank
        if engine == "auto":
            logger.close()
            with open(log) as f:
                first = json.loads(f.readline())
            assert first["engine_resolved"] == "taps-int8"


# (name, N, H, W, C, layout, out column offset): the layouts and shapes the
# tower's taps do not cover — a position count that is not a multiple of
# the tile, channel counts off the 32-channel chunk or over 1024, one
# image, an NCHW-contiguous tap (the generic load path), an out slice at an
# unaligned column (no 16-byte stores), and more images than the grid has
# blocks (each block walks several)
EPILOGUE_EDGE_CASES = [
    ("ragged_positions", 3, 5, 7, 64, "nhwc", 0),
    ("c17", 4, 3, 3, 17, "nhwc", 0),
    ("c40", 4, 6, 2, 40, "nhwc", 0),
    ("c96", 4, 9, 9, 96, "nhwc", 0),
    ("c1056", 2, 3, 2, 1056, "nhwc", 0),
    ("n1", 1, 64, 64, 64, "nhwc", 0),
    ("nchw", 3, 8, 8, 128, "nchw", 0),
    ("unaligned_out", 3, 8, 8, 128, "nhwc", 3),
    ("two_waves", 1500, 4, 4, 512, "nhwc", 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("name,n,h,w,c,layout,col", EPILOGUE_EDGE_CASES,
                         ids=[case[0] for case in EPILOGUE_EDGE_CASES])
def test_tap_epilogue_kernel_edge_cases(cuda_device, mode, name, n, h, w, c,
                                        layout, col):
    """Parts bit for bit, rn within rtol 1e-6, and rn the same on a second
    launch (it is reduced in a fixed order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    if layout == "nchw":
        tap = torch.relu(torch.randn((n, c, h, w), generator=gen,
                                     device=cuda_device)).to(dt)
        tap = tap.permute(0, 2, 3, 1)
    else:
        tap = torch.relu(torch.randn((n, h, w, c), generator=gen,
                                     device=cuda_device)).to(dt)
    scale = torch.rand((c,), generator=gen, device=cuda_device) * 0.05
    kw = dict(embed_dtype=dt,
              out_dtype=torch.float32 if mode == "f32" else dt,
              quant_bound=float(scale.max()) if mode == "int8" else None)
    want, rn_want = tap_epilogue_plain(tap, scale, **kw)
    width = h * w * c
    buf = torch.zeros((n, col + width + 5), dtype=want.dtype,
                      device=cuda_device)
    before = tap_epilogue.launches
    part, rn = tap_epilogue(tap, scale, out=buf[:, col:col + width], **kw)
    _, rn2 = tap_epilogue(tap, scale, out=buf[:, col:col + width], **kw)
    torch.cuda.synchronize()
    assert tap_epilogue.launches == before + 2
    assert bool((part == want).all()), (name, mode)
    assert bool((buf[:, :col] == 0).all() and (buf[:, col + width:] == 0)
                .all())
    torch.testing.assert_close(rn, rn_want, rtol=1e-6, atol=0)
    assert torch.equal(rn, rn2)


@pytest.mark.cuda
def test_kernel_on_binary_rows_at_k1071(cuda_device):
    """The tabular path's shape: medGAN's K = 1,071 (not a multiple of 4,
    8 or the tile's depth) on sparse binary rows scaled by 1/sqrt(K), where
    whole sets of synthetic rows tie. Held against the plain version and
    against float64: every d within TOL * (rq + rs) of its pair's float64
    distance, and each pick within 2 TOL * (rq + rs) of the float64
    minimum."""
    from ganleaks_tpu_torch.ops.distance import rows_embedding

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    k = 1071
    p = torch.rand((k,), generator=gen, device=cuda_device) * 0.1
    q = rows_embedding((torch.rand((700, k), generator=gen,
                                   device=cuda_device) < p).float())
    s = rows_embedding((torch.rand((3000, k), generator=gen,
                                   device=cuda_device) < p).float())
    s[1234] = s[17] = q[5]  # exact copies: distance 0, lower index wins
    rq, rs = sq_norms(q), sq_norms(s)
    before = dict(knn_argmin_fused.launches_by_route)
    d, i = knn_argmin_fused(q, s, rq=rq, rs=rs)
    torch.cuda.synchronize()
    assert launched_on(knn_argmin_fused, torch.float32, before)
    d_p, i_p = knn_argmin_plain(q, s, rq, rs)
    tol = TOL * (rq + rs[i_p.long()])
    assert bool(((d - d_p).abs() <= tol).all())
    q64, s64 = q.double(), s.double()
    d64 = (q64 ** 2).sum(1)[:, None] + (s64 ** 2).sum(1)[None, :] \
        - 2.0 * (q64 @ s64.T)
    pick = d64.gather(1, i.long()[:, None])[:, 0]
    bound = TOL * (rq.double() + rs.double()[i.long()])
    assert bool(((d.double() - pick).abs() <= bound).all())
    assert bool((pick - d64.min(1).values <= 2.0 * bound).all())
    assert int(i[5]) == 17


@pytest.mark.cuda
def test_inception_tower_cuda_matches_cpu(cuda_device):
    """The float32 tower on the card (cuDNN, TF32 off) against the same
    module on the CPU: within 1e-4 of the activations' max."""
    from ganleaks_tpu_torch.ops.fid import get_activations, init_inception_params

    model = init_inception_params(0)
    imgs = np.random.default_rng(0).integers(0, 256, (6, 64, 64, 3),
                                             dtype=np.uint8)
    cpu = get_activations(model, imgs, batch_size=3, device="cpu")
    gpu = get_activations(model, imgs, batch_size=3, device=cuda_device)
    np.testing.assert_allclose(gpu, cpu, rtol=0,
                               atol=1e-4 * np.abs(cpu).max())


@pytest.mark.cuda
def test_spectral_norm_layer_cuda_matches_cpu(cuda_device):
    """One power iteration per forward on the card as on the CPU, the u/v
    buffers unchanged by the forward."""
    from ganleaks_tpu_torch.ops.nn import SNConvTranspose2d

    torch.manual_seed(0)
    layer = SNConvTranspose2d(32, 16, 4, 2, 1).eval()
    x = torch.randn((4, 32, 8, 8))
    with torch.no_grad():
        want = layer(x)
        u, v = layer.u.clone(), layer.v.clone()
        layer = layer.to(cuda_device)
        got = layer(x.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(layer.u.cpu(), u) and torch.equal(layer.v.cpu(), v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,h,w", [(4, 64, 64, 64), (3, 192, 7, 9),
                                     (2, 512, 1, 1), (5, 16, 33, 2)])
@pytest.mark.parametrize("pool", [False, True])
def test_bias_relu_pool_kernel_matches_plain(cuda_device, dtype, n, c, h, w,
                                             pool):
    """The tower's pass after a convolution against its plain version
    (PyTorch's ops on the card) bit for bit, NaN and signed zeros
    included; one launch, in place."""
    from ganleaks_tpu_torch.ops.lpips.bias_relu import (
        bias_relu_pool, bias_relu_pool_plain)

    g = torch.Generator(device=cuda_device).manual_seed(c + h)
    b = torch.randn(c, generator=g, device=cuda_device).to(dtype)
    b[::5] = -0.0
    x = torch.randn((n, h, w, c), generator=g, device=cuda_device).to(dtype)
    x[:, ::3, ::2] = -b
    flat = x.view(-1)
    flat[::97] = float("nan")
    flat[1::89] = -0.0
    x = x.permute(0, 3, 1, 2)
    if pool and min(h, w) < 2:  # F.max_pool2d refuses it too
        with pytest.raises(ValueError, match="two rows and two columns"):
            bias_relu_pool(x, b, pool)
        return
    want_y, want_p = bias_relu_pool_plain(x, b, pool)
    before = bias_relu_pool.launches
    y, p = bias_relu_pool(x, b, pool)
    assert bias_relu_pool.launches == before + 1
    assert y.data_ptr() == x.data_ptr()
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for got, want in ((y, want_y), (p, want_p)) if pool else ((y, want_y),):
        assert got.shape == want.shape
        assert torch.equal(got.permute(0, 2, 3, 1).contiguous().view(ints),
                           want.permute(0, 2, 3, 1).contiguous().view(ints))
