"""Tests of the port that need a CUDA device: the fused distance+argmin
kernel against its plain PyTorch version on the card, and the streamed
search launching it. They skip without a GPU.

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance: |d_kernel - d_plain| <= 1e-5 * (rq + rs) — the two sum the K
products in different orders and rq + rs - 2 q.s cancels; indices must be
equal wherever the plain version's best two distances are further apart
than that, and on planted exact ties.
"""

import numpy as np
import pytest
import torch

from ganleaks_tpu_torch.ops.knn import knn_argmin_streamed
from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                              knn_argmin_plain, sq_norms)

TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from ganleaks_tpu_torch.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n_s,k", [(300, 1000, 1000), (70, 50, 4099)])
def test_kernel_matches_plain(cuda_device, dtype, n_q, n_s, k):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((n_q, k), generator=gen, device=cuda_device)
    s = torch.randn((n_s, k), generator=gen, device=cuda_device)
    s[n_s - 1] = s[10] = q[3] + 0.1  # exact tie, lower index must win
    q, s = q.to(dtype), s.to(dtype)
    rq, rs = sq_norms(q), sq_norms(s)
    before = knn_argmin_fused.launches
    d, i = knn_argmin_fused(q, s, rq=rq, rs=rs)
    torch.cuda.synchronize()
    assert knn_argmin_fused.launches == before + 1
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
