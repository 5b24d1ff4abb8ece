"""The int8 argmin fold (``ops/knn_int8``) on the CPU: what the CUDA kernel
(``csrc/knn_int8_fold.cu``) is handed and how its work is laid out, and
its arithmetic emulated in numpy against the per-part chain it replaces.

* the wrapper's CPU route is the per-part chain (``_fold_block_parts_q``),
  and the kernel's arithmetic — one exact int32 dot per part, promoted as
  ``float32(dot) * float32(f)`` and summed in part order, ``d = (rq + rs)
  - 2 * cross``, each 256-column tile's first minimum merged in tile order
  and into the running state with strict ``<`` — equals it bit for bit,
  ties and the masked tail included;
* the route is decided from the widths and K alone, in one place
  (``argmin_fold``);
* the part table: ends in 32-byte steps, factors as the float32 torch
  multiplies by;
* the launch planner (clusters of ``CLUSTER`` CTAs, tiles, the banded
  work order) as pure Python;
* the fold counters in ``attack_arrays``' ``counters``; the top-k int8
  fold keeps the per-part chain.
"""

import numpy as np
import pytest
import torch

from ganleaks_tpu_torch.attack.fbb import attack_arrays
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.ops import knn, knn_int8
from ganleaks_tpu_torch.ops.knn_int8 import (_fold_block_parts_q,
                                             argmin_fold, int8_argmin_fold,
                                             item_coords, kernel_route,
                                             launch_plan, part_table)

VGG = (12288, 262144, 131072, 65536, 32768, 8192)
ALEX = (12288, 14400, 9408, 3456, 2304, 2304)


def _inputs(widths, n_q, n_s, seed, lo=-20, hi=20, dups=True):
    """Seeded int8 rows, float32 norms of the dequantised rows, factors of
    per-part bounds; the first synthetic rows copy query rows and later
    ones repeat earlier synthetic rows (ties in a tile, across tiles)."""
    rng = np.random.default_rng(seed)
    k = sum(widths)
    q = rng.integers(lo, hi + 1, (n_q, k), dtype=np.int8)
    s = rng.integers(lo, hi + 1, (n_s, k), dtype=np.int8)
    if dups:
        n = min(4, n_q, n_s)
        s[:n] = q[:n]
        s[n_s - 1:n_s - 1 - n:-1] = s[:n]  # the same rows at the far end
    bounds = np.linspace(0.5, 2.0, len(widths))
    factors = tuple(float((a / 127.0) ** 2) for a in bounds)

    def norms(x):
        out, off = np.zeros(len(x)), 0
        for w, f in zip(widths, factors):
            out += (x[:, off:off + w].astype(np.float64) ** 2).sum(1) * f
            off += w
        return torch.from_numpy(out.astype(np.float32))

    return (torch.from_numpy(q), norms(q), torch.from_numpy(s), norms(s),
            factors)


def _kernel_emulated(run, q, rq, s, rs, col0, n_valid, widths, factors,
                     tile=knn_int8.TILE_COLS):
    """The kernel's arithmetic in numpy float32: per part the exact dot,
    ``float32(dot) * float32(f)`` added in part order; d on the fragment;
    each tile's first minimum, the tiles merged in order and the running
    state last, both with strict ``<``."""
    f32 = np.float32
    qn, sn = q.numpy().astype(np.int64), s.numpy().astype(np.int64)
    _, fs = part_table(widths, factors)
    cross, off = None, 0
    for w, f in zip(widths, fs):
        dot = qn[:, off:off + w] @ sn[:, off:off + w].T  # exact
        c = dot.astype(f32) * f32(f)
        cross = c if cross is None else (cross + c).astype(f32)
        off += w
    d = (rq.numpy()[:, None] + rs.numpy()[None, :]).astype(f32) \
        - f32(2) * cross
    run_min, run_idx = (x.numpy().copy() for x in run)
    for m in range(d.shape[0]):
        best, bi = f32(np.inf), 0
        for t0 in range(0, n_valid, tile):
            row = d[m, t0:min(n_valid, t0 + tile)]
            j = int(np.argmin(row))  # the tile's first minimum
            if row[j] < best:
                best, bi = row[j], t0 + j
        if best < run_min[m]:
            run_min[m], run_idx[m] = best, col0 + bi
    return run_min, run_idx


def _fresh(n):
    return (torch.full((n,), torch.inf), torch.zeros(n, dtype=torch.int32))


CASES = {
    # (widths, n_q, n_s, n_valid): a masked tail across three tiles
    "three_tiles_masked": ((64, 96, 32), 12, 700, 650),
    # AlexNet's six parts, each cut to a few 32-byte steps
    "alex_like": ((384, 448, 288, 96, 64, 64), 9, 300, 300),
    "part32": ((32, 4096, 64, 32, 160), 7, 40, 33),
    "one_part": ((96,), 5, 260, 257),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("state", ["fresh", "tying"])
def test_kernel_arithmetic_equals_the_chain(case, state):
    """The CPU route (the chain) and the kernel's emulated arithmetic give
    the same minima (as bits) and indices: from a fresh state, and from a
    running state that already holds each even row's minimum (ties: the
    earlier block keeps its index)."""
    widths, n_q, n_s, n_valid = CASES[case]
    q, rq, s, rs, f = _inputs(widths, n_q, n_s, seed=len(case))
    run = _fresh(n_q)
    if state == "tying":
        d0, i0 = _fold_block_parts_q(*run, q, rq, s, rs, 0, n_valid,
                                     widths, f)
        odd = torch.arange(n_q) % 2 == 1
        run = (torch.where(odd, torch.inf, d0),
               torch.where(odd, 0, i0).to(torch.int32))
    got = int8_argmin_fold(*run, q, rq, s, rs, 1000, n_valid, widths, f)
    want = _fold_block_parts_q(*run, q, rq, s, rs, 1000, n_valid, widths, f)
    emu = _kernel_emulated(run, q, rq, s, rs, 1000, n_valid, widths, f)
    assert got[0].numpy().view(np.int32).tolist() == \
        want[0].numpy().view(np.int32).tolist()
    assert got[1].tolist() == want[1].tolist()
    np.testing.assert_array_equal(emu[0].view(np.int32),
                                  want[0].numpy().view(np.int32))
    np.testing.assert_array_equal(emu[1], want[1].numpy())
    if state == "tying":  # every even row tied and kept its earlier index
        assert got[1][::2].tolist() == run[1][::2].tolist()


def test_masked_rows_never_win():
    """Rows at and past ``n_valid`` (the block's zero padding, here made
    the closest rows) are never picked."""
    widths = (32, 64)
    q, rq, s, rs, f = _inputs(widths, 6, 300, seed=3, dups=False)
    s[280:] = q[0]
    rs[280:] = -1e6
    d, i = int8_argmin_fold(*_fresh(6), q, rq, s, rs, 0, 280, widths, f)
    assert int(i.max()) < 280 and bool(torch.isfinite(d).all())
    emu = _kernel_emulated(_fresh(6), q, rq, s, rs, 0, 280, widths, f)
    np.testing.assert_array_equal(emu[1], i.numpy())


ROUTES = [
    (VGG, sum(VGG), True),
    (ALEX, sum(ALEX), True),
    ((32,), 32, True),
    ((32, 4096, 64, 32, 8192), 12416, True),
    ((2352,), 2352, False),            # 3 x 28 x 28 pixels: 16-byte steps
    ((12288, 14416, 9408), 36112, False),
    ((64, 96), 192, False),            # K is not their sum
    ((0, 64), 64, False),
    ((32,) * 17, 544, False),          # more parts than the kernel holds
]


@pytest.mark.parametrize("widths,k,fused", ROUTES)
def test_route_from_widths(widths, k, fused):
    """The kernel takes every width on its 32-byte steps (K their sum, at
    most 16 parts); anything else is refused by the wrapper, which never
    falls back."""
    assert kernel_route(widths, k) is fused
    if not fused and sum(widths) == k and all(w > 0 for w in widths):
        q, rq, s, rs, f = _inputs(widths, 3, 4, seed=0, dups=False)
        with pytest.raises(ValueError, match="off the kernel"):
            int8_argmin_fold(*_fresh(3), q, rq, s, rs, 0, 4, widths, f)


@pytest.mark.parametrize("widths,k,fused", ROUTES)
def test_argmin_fold_chooses_by_route(widths, k, fused):
    """The one choice every caller makes: the kernel's wrapper on its
    route, the per-part chain on any other widths."""
    want = int8_argmin_fold if fused else _fold_block_parts_q
    assert argmin_fold(widths, k) is want
    assert argmin_fold(list(widths), k) is want


def test_part_table_ends_and_factors():
    """Ends are cumulative 32-byte steps; each factor is the float32 that
    ``float32_tensor * python_float`` multiplies by (the kernel's
    ``__fmul_rn`` then gives torch's bits for every int32 dot)."""
    bounds = (1.0, 0.37, 2.6, 0.051, 11.0, 0.9)
    factors = tuple((a / 127.0) ** 2 for a in bounds)
    ends, fs = part_table(VGG, factors)
    assert ends == (384, 8576, 12672, 14720, 15744, 16000)
    assert ends[-1] * knn_int8.STEP_K == sum(VGG)
    rng = np.random.default_rng(0)
    dots = torch.from_numpy(rng.integers(-2 ** 30, 2 ** 30, 4096,
                                         dtype=np.int64).astype(np.int32))
    for f, f32 in zip(factors, fs):
        assert f32 == float(np.float32(f))
        torch_bits = (dots.float() * f).numpy().view(np.int32)
        table_bits = (dots.float().numpy() * np.float32(f32)).view(np.int32)
        np.testing.assert_array_equal(torch_bits, table_bits)


@pytest.mark.parametrize("n_q,n_valid,max_clusters", [
    (20480, 8192, 66),   # the grid cell's block
    (20480, 1696, 66),   # its last block: 7 tiles
    (1000, 2900, 66),
    (100, 10, 66),       # fewer items than clusters
    (20000, 8192, 30),   # fewer clusters resident than the card's SMs hold
    (20000, 257, 1),     # one cluster walks every item
])
def test_launch_plan(n_q, n_valid, max_clusters):
    """Query groups of ``CLUSTER`` 128-row tiles, 256-column synthetic
    tiles, no more clusters than items or than can be resident, one
    workspace of 256 x 128 floats per CTA."""
    cluster = knn_int8.CLUSTER
    p = launch_plan(n_q, n_valid, max_clusters)
    assert p.n_qg == -(-n_q // (128 * cluster))
    assert p.n_st == -(-n_valid // 256)
    assert p.items == p.n_qg * p.n_st
    assert p.clusters == min(p.items, max_clusters)
    assert p.grid == p.clusters * cluster
    assert p.ws_floats == p.grid * 256 * 128


@pytest.mark.parametrize("n_qg,n_st,band", [(80, 32, 8), (79, 7, 8),
                                            (5, 3, 2), (3, 4, 8), (1, 1, 8)])
def test_item_order_covers_every_tile_once(n_qg, n_st, band):
    """The banded work order is a bijection onto (query group, synthetic
    tile); within a band the query group varies fastest."""
    seen = [item_coords(it, n_qg, n_st, band) for it in range(n_qg * n_st)]
    assert sorted(seen) == [(g, t) for g in range(n_qg)
                            for t in range(n_st)]
    height = min(band, n_qg)
    assert [g for g, _ in seen[:height]] == list(range(height))
    assert {t for _, t in seen[:height]} == {0}


def test_launch_plan_refuses_no_residency():
    with pytest.raises(ValueError, match="cannot be resident"):
        launch_plan(100, 100, 0)


def _sets(res, n_syn=40, n_q=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n_syn, res, res, 3), np.uint8),
            rng.integers(0, 256, (n_q, res, res, 3), np.uint8),
            rng.integers(0, 256, (n_q, res, res, 3), np.uint8))


@pytest.mark.parametrize("res,engine,want", [
    (8, "taps-int8", (5, 0)),   # 192-byte pixel rows: the kernel's route
    (28, "taps-int8", (0, 5)),  # 2,352-byte rows: the per-part chain
    (8, "gemm", (0, 0)),
    (8, "taps", (0, 0)),
])
def test_fold_counters_in_attack_arrays(res, engine, want):
    """``int8_fold_kernel_blocks`` / ``int8_fold_parts_blocks`` count the
    blocks of each route (40 synthetic rows in blocks of 8)."""
    syn, pos, neg = _sets(res)
    cfg = AttackConfig(distance="l2", resolution=res, engine=engine,
                       query_block=4, syn_block=8, save_plots=False)
    out = attack_arrays(cfg, syn, pos, neg, device="cpu")
    c = out["counters"]
    assert (c["int8_fold_kernel_blocks"], c["int8_fold_parts_blocks"]) \
        == want


def test_streamed_search_routes_and_counts(monkeypatch):
    """``knn_argmin_streamed(engine='taps-int8')``: the spec folds every
    block through ``int8_argmin_fold`` where the widths take its route
    and through the per-part chain otherwise, and ``info`` counts both."""
    from ganleaks_tpu_torch.attack.fbb import build_embed_fn
    calls = []
    real = knn_int8.int8_argmin_fold

    def spy(*a, **k):
        calls.append(a[-2])  # the widths
        return real(*a, **k)

    monkeypatch.setattr(knn_int8, "int8_argmin_fold", spy)
    for res, kernel in ((8, True), (28, False)):
        calls.clear()
        syn, pos, _ = _sets(res, n_syn=20)
        cfg = AttackConfig(distance="l2", resolution=res, engine="taps-int8")
        embed = build_embed_fn(cfg, "cpu", structured=True)
        info: dict = {}
        knn.knn_argmin_streamed(embed, pos, syn, engine="taps-int8",
                                q_block=4, s_block=8, info=info)
        assert (info["int8_fold_kernel_blocks"],
                info["int8_fold_parts_blocks"]) == ((3, 0) if kernel
                                                    else (0, 3))
        assert len(calls) == (3 if kernel else 0)


def test_topk_int8_fold_keeps_the_chain(monkeypatch):
    """The two-pass mode's pass 1 (a top-k int8 fold) never reaches the
    argmin kernel: it keeps the per-part products."""
    from ganleaks_tpu_torch.attack.fbb import build_embed_fn

    def refuse(*a, **k):
        raise AssertionError("the top-k fold called the argmin fold")

    monkeypatch.setattr(knn_int8, "int8_argmin_fold", refuse)
    syn, pos, _ = _sets(8, n_syn=20)
    cfg = AttackConfig(distance="l2", resolution=8, engine="taps-int8")
    embed = build_embed_fn(cfg, "cpu", structured=True)
    info: dict = {}
    d, i = knn.knn_topk_streamed(embed, pos, syn, k=3, engine="taps-int8",
                                 q_block=4, s_block=8, info=info)
    assert d.shape == (len(pos), 3)
    assert (info["int8_fold_kernel_blocks"],
            info["int8_fold_parts_blocks"]) == (0, 0)
