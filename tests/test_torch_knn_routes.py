"""The two cross-term tiles of the fused kNN kernels (K1
``csrc/knn_argmin.cu``, K3 ``csrc/knn_topk.cu``), checked on the CPU where
their Python side decides: which tile a dtype takes, the zero-padded copy
that gives TMA 16-byte rows (K a multiple of 4 float32 or 8 bfloat16
values), and the split of the synthetic axis into spans.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Tolerance for the padded rows: indices identical and d
within rtol 1e-6 on bfloat16 rows (exact products), within
1e-6 * (rq + rs) on float32 rows — the zero columns add exact zeros, so the
only change is the order of the float32 matmul's sums.
"""

import numpy as np
import pytest
import torch

from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                              knn_argmin_plain,
                                              knn_topk_fused, knn_topk_plain,
                                              pad_k, route, sq_norms,
                                              tiles_per_split)

N_SM = 132  # an H100 SXM


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, "tf32x3"), (torch.bfloat16, "wgmma"),
    (torch.float16, None), (torch.int8, None), (torch.float64, None)])
def test_route_by_dtype(dtype, want):
    """float32 takes the 3xTF32 tile, bfloat16 the wgmma tile; the wrappers
    refuse every other dtype before touching a device."""
    if want is not None:
        assert route(dtype) == want
        return
    with pytest.raises(ValueError, match="dtype"):
        route(dtype)
    q = torch.zeros((4, 8), dtype=dtype)
    with pytest.raises(ValueError, match="dtype"):
        knn_argmin_fused(q, q)
    with pytest.raises(ValueError, match="dtype"):
        knn_topk_fused(q, q, 2)


@pytest.mark.parametrize("dtype,multiple", [(torch.bfloat16, 8),
                                            (torch.float32, 4)])
@pytest.mark.parametrize("k_dim", [1, 7, 4099, 8, 64])
def test_pad_k_adds_zero_columns_only(rng, k_dim, dtype, multiple):
    """The padded copy keeps every value, adds only zeros up to the next
    multiple of 8 bfloat16 or 4 float32 values (16 bytes; nothing at all
    when K already is one), and leaves the plain versions' results
    unchanged."""
    q = torch.from_numpy(rng.standard_normal((9, k_dim)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal((70, k_dim)).astype(np.float32))
    s[40] = s[13] = q[2] + 0.01  # an exact tie
    qb, sb = q.to(dtype).clone(), s.to(dtype).clone()  # aligned by torch
    qp, sp = pad_k(qb), pad_k(sb)
    k_pad = -(-k_dim // multiple) * multiple
    assert qp.shape == (9, k_pad) and sp.shape == (70, k_pad)
    assert torch.equal(qp[:, :k_dim], qb) and torch.equal(sp[:, :k_dim], sb)
    assert not qp[:, k_dim:].any() and not sp[:, k_dim:].any()
    if k_pad == k_dim:
        assert qp is qb and sp is sb

    d, i = knn_argmin_plain(qb, sb)
    d_p, i_p = knn_argmin_plain(qp, sp)
    assert torch.equal(i, i_p)
    dk, ik = knn_topk_plain(qb, sb, 5)
    dk_p, ik_p = knn_topk_plain(qp, sp, 5)
    assert torch.equal(ik, ik_p)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(d_p, d, rtol=1e-6, atol=0)
        torch.testing.assert_close(dk_p, dk, rtol=1e-6, atol=0)
    else:  # float32 products round: the sum order moves d by ~eps (rq + rs)
        rq, rs = sq_norms(qb), sq_norms(sb)
        assert bool(((d_p - d).abs() <= 1e-6 * (rq + rs[i.long()])).all())
        assert bool(((dk_p - dk).abs()
                     <= 1e-6 * (rq[:, None] + rs[ik.long()])).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pad_k_copies_a_misaligned_view(dtype):
    """A row view that starts off a 16-byte boundary gets an aligned copy
    even when its rows are 16-byte multiples (TMA needs an aligned base)."""
    x = torch.arange(8 * 17, dtype=dtype).reshape(17, 8)
    view = x.view(-1)[1:129].view(16, 8)
    out = pad_k(view)
    assert out.data_ptr() % 16 == 0 and out is not view
    assert torch.equal(out, view)


# (n_q, n_s, tiles per split, splits), worked by hand with 128-row tiles on
# 132 SMs. Both tiles (float32's 3xTF32, bfloat16's) run one CTA per SM: the
# span with the fewest waves x span, the longer among equals.
@pytest.mark.parametrize("n_q,n_s,want_tps,want_splits", [
    # the attack's block: 16 x 16 tiles; span 1 = 2 waves of 256 CTAs,
    # span 2 = 1 wave of 128: the same 2 tile-times, the longer span wins
    (2048, 2048, 2, 8),
    # the tabular attack's float32 fold: 37 x 79 tiles; span 1 = 23 waves
    # of 2,923 CTAs, every longer span 24 tile-times or more
    (4652, 10000, 1, 79),
    # ragged: 2 x 8 tiles (the last 104 rows) fit one wave at span 1
    (200, 1000, 1, 8),
    # one query tile, 547 synthetic tiles: span 1 = 5 waves, span 5 = 110
    # CTAs in 1 wave, both 5 tile-times; spans 2..4 take 6 or 8
    (100, 70000, 5, 110),
    # the north star's 'taps' bf16 launch, 160 x 16 tiles: spans 1, 2 and
    # 4 all take 20 tile-times (20, 10 and 5 waves), the longest wins
    (20480, 2048, 4, 4),
    # one synthetic tile smaller than the tile
    (130, 50, 1, 1),
    # many query tiles, two synthetic tiles: 80 CTAs, one wave at span 1
    (5000, 129, 1, 2),
    # phase 2's K = 512,000 case: 2 x 3 tiles, one wave at span 1
    (256, 300, 1, 3),
])
def test_split_covers_every_tile_once(n_q, n_s, want_tps, want_splits):
    """Span j covers tiles [j tps, min(n_tiles, (j + 1) tps)), as the
    kernels compute it; together the spans cover every synthetic tile
    exactly once, none is empty, and the plan is the one worked by hand."""
    tile = 128
    n_tiles = -(-n_s // tile)
    tps = tiles_per_split(n_q, n_s, tile, N_SM)
    n_splits = -(-n_tiles // tps)
    seen = []
    for j in range(n_splits):
        span = list(range(j * tps, min(n_tiles, (j + 1) * tps)))
        assert span, f"span {j} is empty"
        seen += span
    assert seen == list(range(n_tiles))
    assert (tps, n_splits) == (want_tps, want_splits)
