"""The fused distance+argmin wrapper and the streamed 1-NN search of the
port against the JAX package on the CPU: ``knn_argmin_pallas(...,
interpret=True, demote=False)`` (the Pallas kernel in interpret mode) and
``knn_argmin_streamed(engine='pallas')`` (interpret mode off-TPU).

Indices must be identical. Distances agree within 1e-6 relative to
rq + rs, the size of the terms that cancel in rq + rs - 2 q.s: both sides
compute that expression in float32 with K-sums in different orders, so
the rounding scales with the norms, not with the (smaller) distance.

On the CPU the wrapper takes its plain PyTorch version; the CUDA kernel
itself is compared with that version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.ops import knn as jknn
from ganleaks_tpu.ops.knn_pallas import knn_argmin_pallas
from ganleaks_tpu_torch.ops import knn as tknn
from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                              knn_argmin_plain, sq_norms)

RTOL = 1e-6


def assert_d_close(d_t, d_j, q, s, idx):
    """|d_port - d_jax| <= RTOL * (rq + rs) at the chosen rows."""
    q, s = np.asarray(q, np.float64), np.asarray(s, np.float64)
    scale = (q ** 2).sum(1) + (s[np.asarray(idx)] ** 2).sum(1)
    err = np.abs(np.asarray(d_t, np.float64) - np.asarray(d_j, np.float64))
    assert np.all(err <= RTOL * scale), float((err / scale).max())


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


CASES = [
    # (n_q, n_s, k, ties): ragged n_s, ties across the JAX tiles
    (20, 300, 96, [(3, 7, 250), (11, 128, 129)]),
    (9, 129, 64, [(0, 0, 128)]),
    (33, 50, 130, [(32, 49, 49)]),   # a == b: a plain near copy
]


@pytest.mark.parametrize("n_q,n_s,k,ties", CASES)
def test_plain_matches_pallas_interpret(rng, n_q, n_s, k, ties):
    q, s = _data(rng, n_q, n_s, k, ties)
    d_j, i_j = knn_argmin_pallas(jnp.asarray(q), jnp.asarray(s),
                                 q_block=8, s_block=128, k_block=128,
                                 interpret=True, demote=False)
    d_t, i_t = knn_argmin_fused(torch.from_numpy(q), torch.from_numpy(s))
    assert d_t.dtype == torch.float32 and i_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert_d_close(d_t.numpy(), d_j, q, s, i_t.numpy())
    for row, a, _b in ties:
        assert int(i_t[row]) == a


def test_wrapper_uses_plain_version_on_cpu_and_counts_nothing(rng):
    q, s = _data(rng, 5, 40, 16)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    before = knn_argmin_fused.launches
    d, i = knn_argmin_fused(qt, st, rq=sq_norms(qt), rs=sq_norms(st))
    d_p, i_p = knn_argmin_plain(qt, st)
    assert knn_argmin_fused.launches == before
    torch.testing.assert_close(d, d_p, rtol=0, atol=0)
    torch.testing.assert_close(i, i_p, rtol=0, atol=0)
    ref = ((qt[:, None, :] - st[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i.numpy(), ref.argmin(1).numpy())


def test_wrapper_bf16_widens_to_f32(rng):
    q, s = _data(rng, 6, 70, 32)
    qb = torch.from_numpy(q).bfloat16()
    sb = torch.from_numpy(s).bfloat16()
    d, i = knn_argmin_fused(qb, sb)
    d32, i32 = knn_argmin_plain(qb.float(), sb.float())
    torch.testing.assert_close(d, d32, rtol=0, atol=0)
    torch.testing.assert_close(i, i32, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="shape|expected"):
        knn_argmin_fused(q, torch.zeros((4, 9)))
    with pytest.raises(ValueError, match="dtype"):
        knn_argmin_fused(q, torch.zeros((4, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="dtype"):
        knn_argmin_fused(q.half(), torch.zeros((4, 8)).half())
    with pytest.raises(ValueError, match="empty"):
        knn_argmin_fused(q, torch.zeros((0, 8)))
    with pytest.raises(ValueError, match="unsupported device"):
        knn_argmin_fused(q.to("meta"), torch.zeros((4, 8), device="meta"))


def _identity(x):
    return x


@pytest.mark.parametrize("engine", ["pallas", "gemm", "exact"])
@pytest.mark.parametrize("cache_rows", [64, 16])  # one chunk / multi-chunk
def test_streamed_matches_jax(rng, engine, cache_rows):
    """Port streamed search against JAX's on identity embeddings: ragged
    synthetic tail (300 = 4*64 + 44), padded query tail, and with
    ``cache_rows=16`` a query cache of two chunks (16 + 4 rows)."""
    q, s = _data(rng, 20, 300, 64, [(3, 7, 250), (19, 64, 65)])
    cache = cache_rows * 64 * 4
    d_j, i_j = jknn.knn_argmin_streamed(
        _identity, jnp.asarray(q), jnp.asarray(s), engine=engine,
        q_block=8, s_block=64, query_cache_bytes=cache)
    d_t, i_t = tknn.knn_argmin_streamed(
        _identity, q, s, engine=engine, q_block=8, s_block=64,
        query_cache_bytes=cache, device="cpu")
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert_d_close(d_t.numpy(), d_j, q, s, i_t.numpy())
    assert int(i_t[3]) == 7 and int(i_t[19]) == 64


@pytest.mark.parametrize("engine", ["pallas", "gemm", "exact"])
def test_knn_argmin_matches_jax(rng, engine):
    """Materialised search; JAX's 'pallas' engine runs only compiled, so
    that case is held against the kernel in interpret mode."""
    q, s = _data(rng, 13, 200, 48, [(2, 5, 150)])
    if engine == "pallas":
        d_j, i_j = knn_argmin_pallas(jnp.asarray(q), jnp.asarray(s),
                                     interpret=True, demote=False)
    else:
        d_j, i_j = jknn.knn_argmin(jnp.asarray(q), jnp.asarray(s),
                                   engine=engine, q_block=8, s_block=64)
    d_t, i_t = tknn.knn_argmin(torch.from_numpy(q), torch.from_numpy(s),
                               engine=engine, q_block=8, s_block=64)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert_d_close(d_t.numpy(), d_j, q, s, i_t.numpy())


def test_streamed_timer_and_errors(rng):
    q, s = _data(rng, 4, 10, 8)
    timer = tknn.PhaseTimer(torch.device("cpu"))
    tknn.knn_argmin_streamed(_identity, q, s, engine="pallas", q_block=2,
                             s_block=4, device="cpu", timer=timer)
    secs = timer.seconds()
    assert set(secs) == {"featurize", "fold"}
    assert all(v >= 0 for v in secs.values())
    with pytest.raises(ValueError, match="unknown kNN engine"):
        tknn.knn_argmin_streamed(_identity, q, s, engine="bogus",
                                 device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tknn.knn_argmin_streamed(_identity, q, s[:0], device="cpu")


def test_fold_block_masks_padded_rows():
    run_min = torch.full((2,), torch.inf)
    run_idx = torch.zeros(2, dtype=torch.int32)
    q = torch.tensor([[0.0, 0.0], [0.0, 5.0]])
    blk = torch.tensor([[3.0, 0.0], [1.0, 0.0], [0.0, 0.0]])  # row 2: pad
    m, i = tknn._fold_block(run_min, run_idx, q, sq_norms(q), blk, 10, 2,
                            "gemm")
    assert i.tolist() == [11, 11]
    assert m.tolist() == [1.0, 26.0]  # unmasked, row 2 would win
    # strict '<': an equal later block keeps the earlier index
    m2, i2 = tknn._fold_block(m, i, q, sq_norms(q), blk[1:2], 20, 1, "exact")
    assert i2.tolist() == [11, 11]
