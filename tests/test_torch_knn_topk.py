"""The fused distance+top-k wrapper and the streamed top-k search of the
port against the JAX package on the CPU: ``knn_topk_pallas(...,
interpret=True, demote=False)`` (the Pallas kernel in interpret mode) and
``knn_topk_streamed`` (engines 'gemm', 'exact', and 'pallas', which runs
the Pallas kernel in interpret mode off-TPU).

Indices must be identical wherever the distance is finite. Distances
agree within rtol 1e-5 / atol 1e-6: both sides compute rq + rs - 2 q.s in
float32 with K-sums in different orders. Past N_s the JAX kernel leaves
its indices unspecified, so those entries are compared on d (+inf) only;
the port fills them with -1.

On the CPU the wrapper takes its plain PyTorch version; the CUDA kernel
itself is compared with that version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.ops import knn as jknn
from ganleaks_tpu.ops.knn_pallas import knn_topk_pallas
from ganleaks_tpu_torch.ops import knn as tknn
from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_plain,
                                              knn_topk_fused, knn_topk_plain,
                                              sq_norms)

RTOL, ATOL = 1e-5, 1e-6


def _data(rng, n_q, n_s, k, ties=()):
    """Normal rows; each (row, a, b) in ``ties`` plants s[a] == s[b] as a
    noisy copy of q[row] — that query's nearest rows, an exact tie."""
    q = rng.standard_normal((n_q, k)).astype(np.float32)
    s = rng.standard_normal((n_s, k)).astype(np.float32)
    for row, a, b in ties:
        near = q[row] + 0.7 * rng.standard_normal(k).astype(np.float32)
        s[a] = near
        s[b] = near
    return q, s


def _assert_topk_equal(d_t, i_t, d_j, i_j):
    d_t, i_t = np.asarray(d_t), np.asarray(i_t)
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    assert d_t.shape == d_j.shape and i_t.shape == i_j.shape
    fin = np.isfinite(d_j)
    np.testing.assert_array_equal(np.isfinite(d_t), fin)
    np.testing.assert_array_equal(i_t[fin], i_j[fin])
    np.testing.assert_array_equal(i_t[~fin], -1)
    np.testing.assert_allclose(d_t[fin], d_j[fin], rtol=RTOL, atol=ATOL)


CASES = [
    # (n_q, n_s, K, k, ties): ragged n_s, ties across the JAX tiles
    (20, 300, 96, 4, [(3, 7, 250), (11, 128, 129)]),
    (9, 129, 64, 3, [(0, 0, 128)]),
    (33, 50, 130, 8, [(32, 49, 49)]),   # a == b: a plain near copy
    (5, 3, 32, 4, []),                  # N_s < k
]


@pytest.mark.parametrize("n_q,n_s,k_dim,k,ties", CASES)
def test_plain_matches_pallas_interpret(rng, n_q, n_s, k_dim, k, ties):
    q, s = _data(rng, n_q, n_s, k_dim, ties)
    d_j, i_j = knn_topk_pallas(jnp.asarray(q), jnp.asarray(s), k=k,
                               q_block=8, s_block=128, k_block=128,
                               interpret=True, demote=False)
    d_t, i_t = knn_topk_fused(torch.from_numpy(q), torch.from_numpy(s), k)
    assert d_t.dtype == torch.float32 and i_t.dtype == torch.int32
    _assert_topk_equal(d_t, i_t, d_j, i_j)
    for row, a, b in ties:
        got = i_t[row].tolist()
        assert got[0] == a
        if b != a:  # the tie pair comes out lower index first
            assert got[1] == b


def test_plain_topk_is_stable_and_fills_minus_one():
    q = torch.zeros((2, 3))
    s = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0], [2.0, 0, 0]])
    d, i = knn_topk_plain(q, s, 3)
    assert i.tolist() == [[0, 1, 2], [0, 1, 2]]  # three equal distances
    d, i = knn_topk_plain(q, s[:2], 4)
    assert i.tolist() == [[0, 1, -1, -1]] * 2
    assert torch.isinf(d[:, 2:]).all() and torch.isfinite(d[:, :2]).all()
    # the top-1 is the argmin kernel's result
    q2 = torch.randn(7, 16)
    s2 = torch.randn(40, 16)
    d1, i1 = knn_argmin_plain(q2, s2)
    dk, ik = knn_topk_plain(q2, s2, 5)
    torch.testing.assert_close(ik[:, 0], i1, rtol=0, atol=0)
    torch.testing.assert_close(dk[:, 0], d1, rtol=0, atol=0)


def test_wrapper_uses_plain_version_on_cpu_and_counts_nothing(rng):
    q, s = _data(rng, 5, 40, 16)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    before = knn_topk_fused.launches
    d, i = knn_topk_fused(qt, st, 4, rq=sq_norms(qt), rs=sq_norms(st))
    d_p, i_p = knn_topk_plain(qt, st, 4)
    assert knn_topk_fused.launches == before
    torch.testing.assert_close(d, d_p, rtol=0, atol=0)
    torch.testing.assert_close(i, i_p, rtol=0, atol=0)
    ref = ((qt[:, None, :] - st[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(
        i.numpy(), torch.sort(ref, dim=1, stable=True).indices[:, :4].numpy())


def test_wrapper_bf16_widens_to_f32(rng):
    q, s = _data(rng, 6, 70, 32)
    qb = torch.from_numpy(q).bfloat16()
    sb = torch.from_numpy(s).bfloat16()
    d, i = knn_topk_fused(qb, sb, 3)
    d32, i32 = knn_topk_plain(qb.float(), sb.float(), 3)
    torch.testing.assert_close(d, d32, rtol=0, atol=0)
    torch.testing.assert_close(i, i32, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="shape|expected"):
        knn_topk_fused(q, torch.zeros((4, 9)), 2)
    with pytest.raises(ValueError, match="dtype"):
        knn_topk_fused(q, torch.zeros((4, 8), dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="empty"):
        knn_topk_fused(q, torch.zeros((0, 8)), 2)
    with pytest.raises(ValueError, match="k must be"):
        knn_topk_fused(q, torch.zeros((4, 8)), 0)
    with pytest.raises(ValueError, match="unsupported device"):
        knn_topk_fused(q.to("meta"), torch.zeros((4, 8), device="meta"), 2)


def _identity(x):
    return x


@pytest.mark.parametrize("engine", ["pallas", "gemm", "exact"])
@pytest.mark.parametrize("cache_rows", [64, 16])  # one chunk / multi-chunk
def test_streamed_matches_jax(rng, engine, cache_rows):
    """Port streamed top-k against JAX's on identity embeddings: ragged
    synthetic tail (300 = 4*64 + 44), padded query tail, two query-cache
    chunks with ``cache_rows=16``, and the certificate's (rq, rs_max)."""
    q, s = _data(rng, 20, 300, 64, [(3, 7, 250), (19, 64, 65)])
    cache = cache_rows * 64 * 4
    d_j, i_j, rq_j, rs_j = jknn.knn_topk_streamed(
        _identity, jnp.asarray(q), jnp.asarray(s), k=4, engine=engine,
        q_block=8, s_block=64, query_cache_bytes=cache, with_info=True)
    d_t, i_t, rq_t, rs_t = tknn.knn_topk_streamed(
        _identity, q, s, k=4, engine=engine, q_block=8, s_block=64,
        query_cache_bytes=cache, with_info=True, device="cpu")
    _assert_topk_equal(d_t, i_t, d_j, i_j)
    assert i_t[3, :2].tolist() == [7, 250]
    assert i_t[19, :2].tolist() == [64, 65]
    np.testing.assert_allclose(rq_t.numpy(), np.asarray(rq_j), rtol=1e-6)
    np.testing.assert_allclose(float(rs_t.max()), float(np.max(rs_j)),
                               rtol=1e-6)


@pytest.mark.parametrize("engine", ["pallas", "gemm"])
def test_streamed_fewer_rows_than_k(rng, engine):
    q, s = _data(rng, 6, 3, 16)
    d_j, i_j = jknn.knn_topk_streamed(_identity, jnp.asarray(q),
                                      jnp.asarray(s), k=5, engine=engine,
                                      q_block=4, s_block=2)
    d_t, i_t = tknn.knn_topk_streamed(_identity, q, s, k=5, engine=engine,
                                      q_block=4, s_block=2, device="cpu")
    _assert_topk_equal(d_t, i_t, d_j, i_j)
    assert (i_t[:, 3:] == -1).all()


def test_merge_keeps_running_entries_first():
    run_d = torch.tensor([[1.0, 2.0, torch.inf]])
    run_i = torch.tensor([[4, 9, -1]], dtype=torch.int32)
    blk_d = torch.tensor([[2.0, 0.5, 2.0]])
    blk_i = torch.tensor([[20, 21, 22]], dtype=torch.int32)
    d, i = tknn._merge_topk(run_d, run_i, blk_d, blk_i, 3)
    assert i.tolist() == [[21, 4, 9]]  # 9 (running) before 20 at d = 2
    assert d.tolist() == [[0.5, 1.0, 2.0]]
