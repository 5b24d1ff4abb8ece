"""The port's device-memory planner (``ganleaks_tpu_torch.ops.stream_plan``),
after ``tests/test_stream_plan.py``: the JAX package's policy (one sweep
when it fits, shrinking ``s_block`` before capping the cache, shrinking
the blocks for wide rows), driven here by ``capacity_bytes`` since the
CPU has no card to read. The charges are the module's measured table at
the north star's rows: VGG16 at 64 px, int8 parts (512,000 bytes a row)
on a bf16 tower."""

import numpy as np
import pytest
import torch

from ganleaks_tpu_torch.ops import knn, stream_plan
from ganleaks_tpu_torch.ops.distance import make_embed_fn
from ganleaks_tpu_torch.ops.stream_plan import (
    ACT_BYTES_PER_ROW_64, BLOCK_FLOOR, FOLD_BYTES_PER_PAIR, GIB,
    S_BLOCK_FLOOR, STREAM_BLOCKS, activation_bytes_per_row,
    device_capacity, margin_bytes, plan_stream)

ROW = 512_000  # taps-int8 bytes per row at 64x64 (K = 512,000)
ACT = ACT_BYTES_PER_ROW_64[("vgg", "bfloat16")]
INT8 = dict(act_bytes_per_row=ACT, state_bytes_per_row=8,
            fold_bytes_per_pair=FOLD_BYTES_PER_PAIR["int8"])
N_Q = 20000
PADDED = 20480  # N_Q padded to q_block 2048


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _need(cache: int, sb: int, qb: int, row: int, act: int, fold: int,
          state: int = 8) -> int:
    """The planner's charge for a plan (module docstring)."""
    rows = cache // row
    blk = max(sb, qb)
    return (rows * (row + 4 + state + fold * sb)
            + STREAM_BLOCKS * blk * row + blk * act)


@pytest.mark.parametrize("capacity_gib,s_block,want_sb", [
    (70, 8192, 8192),   # fits at the requested block
    (30, 8192, 2048),   # fits once s_block is quartered
    (25, 2048, 2048),   # the 2,048-row blocks of the taps engines
])
def test_one_sweep_adopted_when_it_fits(capacity_gib, s_block, want_sb,
                                        capsys):
    cap = capacity_gib * GIB
    cache, sb, qb = plan_stream(N_Q, ROW, q_block=2048, s_block=s_block,
                                cache_bytes=8 * GIB, capacity_bytes=cap,
                                **INT8)
    assert cache >= PADDED * ROW, "every padded query row cached"
    assert (sb, qb) == (want_sb, 2048)
    assert _need(PADDED * ROW, sb, qb, ROW, ACT, 20) <= cap
    assert "one-sweep schedule fits" in capsys.readouterr().out


@pytest.mark.parametrize("s_block", [8192, 2048])
def test_s_block_shrinks_before_the_cache_is_capped(s_block, capsys):
    """12 GiB: one sweep is out of reach even at the floor, so the plan
    walks s_block down to S_BLOCK_FLOOR first and only then caps the 8 GiB
    request (more sweeps, never a plan that cannot fit)."""
    cap = 12 * GIB
    cache, sb, qb = plan_stream(N_Q, ROW, q_block=2048, s_block=s_block,
                                cache_bytes=8 * GIB, capacity_bytes=cap,
                                **INT8)
    assert sb == S_BLOCK_FLOOR and qb == 2048
    assert 2048 * ROW <= cache < 8 * GIB and cache % ROW == 0
    assert _need(cache, sb, qb, ROW, ACT, 20) <= cap
    # one more row would not fit
    assert _need(cache + ROW, sb, qb, ROW, ACT, 20) > cap
    assert "capping" in capsys.readouterr().out


@pytest.mark.parametrize("request_gib,capacity_gib", [(14, 15), (40, 30)])
def test_overambitious_cache_capped_before_allocation(request_gib,
                                                      capacity_gib):
    """A request that can never fit next to the stream is capped (the
    alloc-OOM resume is the second line of defence); the cap holds at
    least one planned q_block of rows."""
    big_row = 4 << 20
    cap = capacity_gib * GIB
    cache, sb, qb = plan_stream(N_Q, big_row, q_block=2048, s_block=2048,
                                cache_bytes=request_gib * GIB,
                                capacity_bytes=cap, **INT8)
    assert cache < request_gib * GIB
    assert cache >= qb * big_row
    assert _need(cache, sb, qb, big_row, ACT, 20) <= cap


@pytest.mark.parametrize("res,capacity_gib", [(256, 15), (512, 70)])
def test_wide_rows_shrink_the_blocks(res, capacity_gib):
    """Rows of 256 / 512 px (VGG16 int8: 16x / 64x the 64-px row, the
    tower's charge scaled by the pixel count): one 2,048-row block and its
    activations exceed the budget, so q_block (and s_block) shrink until
    one chunk of the planned q_block fits."""
    row = ROW * (res // 64) ** 2
    act = activation_bytes_per_row(("vgg", "bfloat16"), (res, res, 3))
    cap = capacity_gib * GIB
    cache, sb, qb = plan_stream(2048, row, q_block=2048, s_block=4096,
                                cache_bytes=8 * GIB, capacity_bytes=cap,
                                act_bytes_per_row=act,
                                fold_bytes_per_pair=20)
    assert BLOCK_FLOOR <= qb < 2048 and BLOCK_FLOOR <= sb < 4096
    assert cache >= qb * row, "one chunk of the planned q_block"
    assert _need(cache, sb, qb, row, act, 20) <= cap


def test_small_request_unchanged(capsys):
    """A shape that fits as requested keeps the request, silently."""
    plan = plan_stream(2000, ROW, q_block=2048, s_block=2048,
                       cache_bytes=8 * GIB, capacity_bytes=70 * GIB, **INT8)
    assert plan == (8 * GIB, 2048, 2048)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu")])
def test_inert_without_a_card(device):
    plan = plan_stream(N_Q, ROW, q_block=2048, s_block=8192,
                       cache_bytes=GIB, device=device, **INT8)
    assert plan == (GIB, 8192, 2048)
    if device is not None:
        assert device_capacity(device) is None


def test_capacity_counts_the_allocators_free_blocks(monkeypatch):
    """The budget is mem_get_info's free bytes plus what the caching
    allocator holds but has not handed out, less the stated margin."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (50 * GIB, 80 * GIB))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda dev=None: 20 * GIB)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev=None: 12 * GIB)
    avail = 58 * GIB
    assert device_capacity("cuda") == avail - margin_bytes(avail)
    assert margin_bytes(avail) == GIB + avail // 20


@pytest.mark.parametrize("tower,shape,want", [
    (("vgg", "bfloat16"), (64, 64, 3), ACT),
    (("vgg", "bfloat16"), (128, 128, 3), 4 * ACT),
    (("alex", "float32"), (32, 32, 3),
     ACT_BYTES_PER_ROW_64[("alex", "float32")] // 4),
    (None, (64, 64, 3), ACT_BYTES_PER_ROW_64[(None, "float32")]),
    (("vgg19", "float32"), (64, 64, 3), max(ACT_BYTES_PER_ROW_64.values())),
])
def test_activation_charge(tower, shape, want):
    assert activation_bytes_per_row(tower, shape) == want


def _tagged(n, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)


@pytest.mark.parametrize("auto_plan", [True, False])
def test_search_adopts_the_plan(monkeypatch, auto_plan):
    """With a capacity the planner turns a two-chunk request into one
    sweep (the synthetic set featurised once, not twice), with identical
    results; ``auto_plan=False`` keeps the request as given."""
    q, s = _tagged(24, 16, 0), _tagged(40, 16, 1)
    embed = make_embed_fn("l2")
    row = 16 * 4
    monkeypatch.setattr(stream_plan, "device_capacity",
                        lambda device: 1 << 30)
    info: dict = {}
    d, i = knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=8,
                                   query_cache_bytes=16 * row,
                                   auto_plan=auto_plan, info=info)
    assert info["sweeps"] == (1 if auto_plan else 2)
    d0, i0 = knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=8,
                                     auto_plan=False)
    np.testing.assert_array_equal(i.numpy(), i0.numpy())
    np.testing.assert_array_equal(d.numpy(), d0.numpy())


def test_attack_config_switches_the_planner_off(monkeypatch):
    from ganleaks_tpu_torch.attack.fbb import attack_arrays
    from ganleaks_tpu_torch.config import AttackConfig

    seen = []
    real = knn._stream_search

    def spy(*a, **kw):
        seen.append(kw["auto_plan"])
        return real(*a, **kw)

    monkeypatch.setattr(knn, "_stream_search", spy)
    imgs = np.random.default_rng(2).integers(0, 256, (6, 8, 8, 3), np.uint8)
    for flag in (True, False):
        attack_arrays(AttackConfig(distance="l2", resolution=8,
                                   auto_plan=flag), imgs, imgs[:3],
                      imgs[3:], device="cpu")
    assert seen == [True, False]


@pytest.mark.parametrize("cache_gib,sb,qb,row,act,fold", [
    (9.5, 2048, 2048, ROW, ACT, FOLD_BYTES_PER_PAIR["int8"]),
    (2.0, 512, 1024, 4 * ROW, ACT_BYTES_PER_ROW_64[("vgg", "float32")],
     FOLD_BYTES_PER_PAIR["gemm"]),
])
def test_plan_bytes_is_the_documented_charge(cache_gib, sb, qb, row, act,
                                             fold):
    cache = int(cache_gib * GIB) // row * row
    assert stream_plan.plan_bytes(
        cache // row, row, s_block=sb, q_block=qb, act_bytes_per_row=act,
        fold_bytes_per_pair=fold) == _need(cache, sb, qb, row, act, fold)


@pytest.mark.parametrize("engine", ["gemm", "pallas"])
@pytest.mark.parametrize("auto_plan", [True, False])
def test_stream_need_bytes_is_what_the_planner_needs(engine, auto_plan):
    """``attack.fbb`` keeps ``stream_need_bytes`` free beside the image
    sets: it is the least budget at which the planner adopts one sweep
    (with ``auto_plan=False``, the requested cache's charge)."""
    imgs = np.random.default_rng(3).integers(0, 256, (24, 8, 8, 3),
                                             np.uint8)
    embed = make_embed_fn("l2")
    row = 8 * 8 * 3 * 4
    request = 8 * row
    need = knn.stream_need_bytes(embed, imgs, engine=engine, q_block=8,
                                 s_block=16, query_cache_bytes=request,
                                 auto_plan=auto_plan,
                                 device=torch.device("cpu"))
    charges = knn._plan_charges(embed, imgs,
                                "fused" if engine == "pallas" else "gemm", 8)
    rows = 24 if auto_plan else 8
    assert need == stream_plan.plan_bytes(rows, row, s_block=16, q_block=8,
                                          **charges)
    if auto_plan:
        def plan(cap):
            return plan_stream(24, row, q_block=8, s_block=16,
                               cache_bytes=request, capacity_bytes=cap,
                               **charges)
        assert plan(need) == (24 * row, 16, 8)
        assert plan(need - 1)[0] < 24 * row


@pytest.mark.parametrize("host_stream,capacity,on_device", [
    (True, 1 << 40, False),      # pinned to host memory
    ("auto", 1000, False),       # does not fit beside the search
    ("bogus", 1 << 40, None),    # refused, as the JAX package does
])
def test_image_sets_stay_on_the_host_unless_they_fit(monkeypatch,
                                                     host_stream, capacity,
                                                     on_device):
    """The sets are copied to the card only where they fit beside what the
    search plans; otherwise the search streams them from host memory."""
    from ganleaks_tpu_torch.attack import fbb
    from ganleaks_tpu_torch.config import AttackConfig

    monkeypatch.setattr(fbb, "device_capacity", lambda device: capacity)
    monkeypatch.setattr(fbb, "stream_need_bytes", lambda *a, **kw: 100)
    q = np.zeros((4, 8, 8, 3), np.uint8)
    s = np.zeros((6, 8, 8, 3), np.uint8)
    cfg = AttackConfig(distance="l2", resolution=8, host_stream=host_stream)
    if on_device is None:
        with pytest.raises(ValueError, match="host_stream"):
            fbb._stage_sets(cfg, None, q, s, torch.device("cuda"))
        return
    got_q, got_s, moved = fbb._stage_sets(cfg, None, q, s,
                                          torch.device("cuda"))
    assert moved is on_device and got_q is q and got_s is s


# K1 / K3's padded copies (``knn_fused.pad_k``): a fused fold of rows that
# are not 16-byte multiples hands the kernel copies of the whole cached
# chunk and of the synthetic block, which the planner now charges
TAB_ACT = 1071 * 4 * 2  # tabular rows: the float32 embedding, twice


@pytest.mark.parametrize("k_dim,dtype", [(1071, torch.float32),
                                         (1001, torch.bfloat16),
                                         (4099, torch.float32)])
@pytest.mark.parametrize("rows,sb,qb", [(4096, 2048, 2048), (600, 512, 64)])
def test_padded_rows_charge_the_copy(k_dim, dtype, rows, sb, qb):
    """At a K whose rows pad, a fused fold's charge exceeds the unpadded
    one by exactly the copies ``pad_k`` makes — (cached rows + s_block) of
    its padded row — and a non-fused fold's does not move."""
    from ganleaks_tpu_torch.ops.knn_fused import pad_k
    elt = torch.empty((), dtype=dtype).element_size()
    row = k_dim * elt
    padded_row = pad_k(torch.zeros(2, k_dim, dtype=dtype)).shape[1] * elt
    assert padded_row > row
    assert stream_plan.pad_copy_bytes(row, True) == padded_row
    kw = dict(s_block=sb, q_block=qb, act_bytes_per_row=TAB_ACT,
              fold_bytes_per_pair=FOLD_BYTES_PER_PAIR["fused"])
    fused = stream_plan.plan_bytes(rows, row, fused_fold=True, **kw)
    plain = stream_plan.plan_bytes(rows, row, **kw)
    assert fused - plain == (rows + sb) * padded_row
    assert stream_plan.pad_copy_bytes(row, False) == 0


def test_budget_without_the_copy_now_plans_smaller():
    """A budget that holds the one-sweep plan only without the padded
    copies no longer adopts it: the fused plan caches fewer rows (more
    sweeps), and what it plans fits with the copies charged."""
    row, n_q = 1071 * 4, 4096
    kw = dict(q_block=2048, s_block=2048, act_bytes_per_row=TAB_ACT,
              fold_bytes_per_pair=FOLD_BYTES_PER_PAIR["fused"])
    cap = stream_plan.plan_bytes(n_q, row, s_block=2048, q_block=2048,
                                 act_bytes_per_row=TAB_ACT,
                                 fold_bytes_per_pair=1)
    request = 2048 * row
    unpadded = plan_stream(n_q, row, cache_bytes=request,
                           capacity_bytes=cap, **kw)
    assert unpadded == (n_q * row, 2048, 2048)
    cache, sb, qb = plan_stream(n_q, row, cache_bytes=request,
                                capacity_bytes=cap, fused_fold=True, **kw)
    assert cache < n_q * row and (sb, qb) <= (2048, 2048)
    assert stream_plan.plan_bytes(cache // row, row, s_block=sb,
                                  q_block=qb, act_bytes_per_row=TAB_ACT,
                                  fold_bytes_per_pair=1,
                                  fused_fold=True) <= cap


@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze", None])
def test_planned_paths_keep_their_plans(net):
    """Every planned path of the attack at 64 px — the VGG16, AlexNet and
    SqueezeNet parts in every cache dtype, and the pixels — has rows of
    16-byte multiples, so the fused charge is the plan of before, bit for
    bit, at budgets across every branch of the policy."""
    from ganleaks_tpu_torch.ops.lpips.lpips import LPIPS
    if net is None:
        widths = [64 * 64 * 3]
    else:
        with torch.no_grad():
            taps = LPIPS(net).features(torch.zeros(1, 64, 64, 3))
        widths = [int(np.prod(t.shape[1:])) for t in taps]
    k_dim = sum(widths)
    for elt in (1, 2, 4):  # int8, bfloat16, float32 caches
        row = k_dim * elt
        assert stream_plan.pad_copy_bytes(row, True) == 0
        act = ACT_BYTES_PER_ROW_64[(net, "float32")]
        for cap_gib in (80, 20, 4, 0.5):
            args = dict(q_block=2048, s_block=2048, cache_bytes=8 * GIB,
                        act_bytes_per_row=act, fold_bytes_per_pair=1,
                        capacity_bytes=int(cap_gib * GIB))
            assert plan_stream(N_Q, row, fused_fold=True, **args) == \
                plan_stream(N_Q, row, **args)


def test_fused_charges_name_the_fold():
    """``_plan_charges`` marks the fused argmin and top-k folds, so every
    streamed search and ``stream_need_bytes`` pass the copies' charge."""
    embed = make_embed_fn("l2")
    imgs = np.zeros((2, 8, 8, 3), np.uint8)
    for kind, fused in (("fused", True), ("topk_fused", True),
                        ("gemm", False), ("int8", False),
                        ("topk_int8", False)):
        assert knn._plan_charges(embed, imgs, kind, 8)["fused_fold"] is fused
