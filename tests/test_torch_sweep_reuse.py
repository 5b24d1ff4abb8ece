"""Query-embedding reuse across calls (``ganleaks_tpu_torch.ops.knn``
``query_reuse`` and ``attack.fbb`` ``sweep_cache``), after the
single-device cases of ``tests/test_knn_sweep_reuse.py``: reuse is exact
and skips the query featurisation, the fbb hyperparameter sweep
featurises its queries once, and a held cache never serves a different
query set or a changed featuriser. The port's fingerprint hashes the
first, the last and strided rows (the JAX package's only the first: a set
with a swapped middle row would reuse its stale cache there). The sweep's
results are held equal to the JAX package's ``run_attack`` on the same
tree."""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from ganleaks_tpu.attack.fbb import run_attack as j_run_attack
from ganleaks_tpu.config import AttackConfig as JAttackConfig
from ganleaks_tpu.ops import knn as jknn
from ganleaks_tpu.ops.distance import make_embed_fn as j_make_embed_fn
from ganleaks_tpu.ops.distance import \
    make_embed_parts_fn as j_make_embed_parts_fn
from ganleaks_tpu_torch.attack.fbb import attack_arrays, run_attack
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.ops import knn, stream_plan
from ganleaks_tpu_torch.ops.distance import make_embed_fn, make_embed_parts_fn


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(n_q=24, n_s=64, d=48, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_q, d)).astype(np.float32),
            rng.normal(size=(n_s, d)).astype(np.float32))


@pytest.fixture
def allocs(monkeypatch):
    """Counts query-cache allocations: one per featurised chunk, none when
    a held cache is reused."""
    calls = {"n": 0}
    real = knn._alloc_cache

    def counting(*a):
        calls["n"] += 1
        return real(*a)

    monkeypatch.setattr(knn, "_alloc_cache", counting)
    return calls


class Counting:
    """A featuriser that counts the rows it featurises."""

    def __init__(self, embed):
        self.embed, self.rows = embed, 0

    def __call__(self, x):
        self.rows += x.shape[0]
        return self.embed(x)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def test_reuse_is_exact_and_skips_featurize(allocs):
    q, s = _data()
    embed = Counting(make_embed_fn("l2"))
    ref = knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=16)
    jd, ji = jknn.knn_argmin_streamed(j_make_embed_fn("l2"), q, s,
                                      q_block=8, s_block=16)
    np.testing.assert_array_equal(ref[1].numpy(), np.asarray(ji))
    np.testing.assert_allclose(ref[0].numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)
    holder: dict = {}
    first = knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=16,
                                    query_reuse=holder)
    assert allocs["n"] == 2 and holder["fp"][0] == len(q)
    rows = embed.rows
    info: dict = {}
    second = knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=16,
                                     query_reuse=holder, info=info)
    assert allocs["n"] == 2, "the second call allocates no query cache"
    assert embed.rows - rows == 1 + len(s), \
        "the second call featurises only the probe and the synthetic set"
    assert info["query_reused"]
    _eq(ref, first)
    _eq(first, second)


def test_reuse_parts_engine(allocs):
    q, s = _data(d=27)
    q4, s4 = q.reshape(-1, 3, 3, 3), s.reshape(-1, 3, 3, 3)
    embed = make_embed_parts_fn("l2")
    jd, ji = jknn.knn_argmin_streamed_parts(j_make_embed_parts_fn("l2"),
                                            q4, s4, q_block=8, s_block=16)
    for engine in ("taps", "taps-int8"):
        ref = knn.knn_argmin_streamed(embed, q4, s4, engine=engine,
                                      q_block=8, s_block=16)
        holder: dict = {}
        knn.knn_argmin_streamed(embed, q4, s4, engine=engine, q_block=8,
                                s_block=16, query_reuse=holder)
        n = allocs["n"]
        again = knn.knn_argmin_streamed(embed, q4, s4, engine=engine,
                                        q_block=8, s_block=16,
                                        query_reuse=holder)
        assert allocs["n"] == n, "the held parts cache is reused"
        _eq(ref, again)
        if engine == "taps":
            np.testing.assert_array_equal(again[1].numpy(), np.asarray(ji))
            np.testing.assert_allclose(again[0].numpy(), np.asarray(jd),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("change", ["reversed", "middle_row_swapped",
                                    "last_row_changed"])
def test_different_queries_do_not_reuse(allocs, change):
    """A same-shaped set that differs must be featurised again, not
    answered from the held cache. A swapped middle row passes the JAX
    package's first-row fingerprint; the port's catches it."""
    q, s = _data()
    other = q.copy()
    if change == "reversed":
        other = q[::-1].copy()
    elif change == "middle_row_swapped":
        other[[11, 12]] = q[[12, 11]]
    else:
        other[-1] += 1.0
    assert other[0].tobytes() == q[0].tobytes() or change == "reversed"
    embed = make_embed_fn("l2")
    holder: dict = {}
    knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=16,
                            query_reuse=holder)
    n = allocs["n"]
    got = knn.knn_argmin_streamed(embed, other, s, q_block=8, s_block=16,
                                  query_reuse=holder)
    assert allocs["n"] == n + 1, "the changed set is featurised again"
    _eq(got, knn.knn_argmin_streamed(embed, other, s, q_block=8,
                                     s_block=16))


def test_reuse_dropped_on_chunk_restart():
    """A held cache never engages (and is dropped) on a multi-chunk
    schedule, and a mismatched n_q does not engage."""
    q, s = _data()
    embed = make_embed_fn("l2")
    holder: dict = {}
    knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=16,
                            query_reuse=holder)
    assert holder["cache"].shape[0] >= len(q)
    got = knn.knn_argmin_streamed(embed, q[:16], s, q_block=8, s_block=16,
                                  query_reuse=holder)
    _eq(got, knn.knn_argmin_streamed(embed, q[:16], s, q_block=8,
                                     s_block=16))
    knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=16,
                            query_cache_bytes=8 * 48 * 4,
                            query_reuse=holder)
    assert holder == {}, "a multi-chunk schedule drops the held cache"


def test_planner_credits_the_held_cache(monkeypatch, allocs):
    """The card reports a held cache as allocated, not free. With a budget
    where the one-sweep cache fits once but not twice, the second call
    must still plan one sweep (the held cache counted back) and reuse it,
    not cap the plan, drop the cache and featurise the queries again."""
    q, s = _data()
    embed = Counting(make_embed_fn("l2"))
    charges = {}
    real_plan = knn.plan_stream

    def spy(n_q, row_bytes, **kw):
        charges.update(kw, n_q=n_q, row_bytes=row_bytes)
        return real_plan(n_q, row_bytes, **kw)

    monkeypatch.setattr(knn, "plan_stream", spy)
    monkeypatch.setattr(stream_plan, "device_capacity",
                        lambda device: 1 << 30)
    knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=16,
                            query_cache_bytes=8 * 48 * 4)
    kw = {k: charges[k] for k in ("act_bytes_per_row", "state_bytes_per_row",
                                  "fold_bytes_per_pair", "q_block",
                                  "s_block", "cache_bytes")}
    need = len(q) * charges["row_bytes"]

    def one_sweep(cap):
        return real_plan(len(q), charges["row_bytes"], capacity_bytes=cap,
                         **kw)[0] >= need

    lo, hi = 0, 1 << 20  # the least budget that plans one sweep
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if one_sweep(mid) else (mid + 1, hi)
    held_bytes = len(q) * (charges["row_bytes"] + 4)
    budget = lo + held_bytes // 2
    assert one_sweep(budget) and not one_sweep(budget - held_bytes)
    holder: dict = {}

    def free_bytes(device):  # the held cache is no longer free
        return budget - (holder["cache"].nbytes + holder["rq"].nbytes
                         if holder else 0)

    monkeypatch.setattr(stream_plan, "device_capacity", free_bytes)
    info: dict = {}
    first = knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=16,
                                    query_cache_bytes=8 * 48 * 4,
                                    query_reuse=holder, info=info)
    assert info["sweeps"] == 1 and holder
    n, rows = allocs["n"], embed.rows
    second = knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=16,
                                     query_cache_bytes=8 * 48 * 4,
                                     query_reuse=holder, info=info)
    assert info["query_reused"] and info["sweeps"] == 1
    assert allocs["n"] == n and embed.rows - rows == 1 + len(s)
    _eq(first, second)
    _eq(first, knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=16,
                                       auto_plan=False))


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "torch"])
def test_reuse_two_pass(allocs, as_tensor):
    """Both holders reused; with torch inputs (what ``attack_arrays``
    hands the search on the card) the fingerprint and the re-rank's
    candidate gather index the tensors."""
    q, s = _data()
    if as_tensor:
        q, s = torch.from_numpy(q), torch.from_numpy(s)
    lo, hi = make_embed_fn("l2"), make_embed_fn("l2")
    ref = knn.knn_argmin_two_pass(lo, hi, q, s, q_block=8, s_block=16)
    lo_h: dict = {}
    hi_h: dict = {}
    first = knn.knn_argmin_two_pass(lo, hi, q, s, q_block=8, s_block=16,
                                    query_reuse=lo_h, rerank_reuse=hi_h)
    n = allocs["n"]
    assert lo_h and hi_h, "both caches held"
    second = knn.knn_argmin_two_pass(lo, hi, q, s, q_block=8, s_block=16,
                                     query_reuse=lo_h, rerank_reuse=hi_h)
    assert allocs["n"] == n, "the second call skips both query featurises"
    _eq(ref, first)
    _eq(first, second)
    jd, ji = jknn.knn_argmin_two_pass(j_make_embed_fn("l2"),
                                      j_make_embed_fn("l2"), np.asarray(q),
                                      np.asarray(s), q_block=8, s_block=16)
    np.testing.assert_array_equal(second[1].numpy(), np.asarray(ji))
    np.testing.assert_allclose(second[0].numpy(), np.asarray(jd),
                               rtol=1e-5, atol=1e-5)


def test_rerank_oom_drops_the_sibling_holder(monkeypatch):
    """An OOM recovery in the two-pass re-rank drops the pass-1 (lo)
    holder as well as its own: the JAX package frees only its own."""
    q, s = _data()
    lo, hi = make_embed_fn("l2"), make_embed_fn("l2")
    lo_h: dict = {}
    hi_h: dict = {}
    real, state = knn._alloc_cache, {"calls": 0}

    def failing_alloc(*a):
        state["calls"] += 1
        if state["calls"] == 2:  # the re-rank's cache (pass 1's is first)
            assert lo_h, "pass 1 holds its cache when the re-rank starts"
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(*a)

    monkeypatch.setattr(knn, "_alloc_cache", failing_alloc)
    info: dict = {}
    got = knn.knn_argmin_two_pass(lo, hi, q, s, q_block=8, s_block=16,
                                  query_reuse=lo_h, rerank_reuse=hi_h,
                                  info=info)
    assert lo_h == {}, "the sibling's held cache was dropped"
    assert info["oom_resumes"] == 1 and info["rerank"]["oom_resumes"] == 1
    monkeypatch.setattr(knn, "_alloc_cache", real)
    _eq(got, knn.knn_argmin_two_pass(lo, hi, q, s, q_block=8, s_block=16))


def _write_tree(tmp_path, n_sub=2):
    """A two-subdir npz tree (one images.npz per subdir) and npz query
    sets: 8x8 uint8 images."""
    rng = np.random.default_rng(1)
    root = tmp_path / "syn_root"
    for j in range(n_sub):
        os.makedirs(root / f"params{j}")
        np.savez(root / f"params{j}" / "images.npz",
                 images=rng.integers(0, 256, (20, 8, 8, 3), np.uint8))
    for name in ("pos", "neg"):
        np.savez(tmp_path / f"{name}.npz",
                 images=rng.integers(0, 256, (6, 8, 8, 3), np.uint8))
    return dict(syn_data_path=str(root), pos_data_dir=str(tmp_path /
                                                          "pos.npz"),
                neg_data_dir=str(tmp_path / "neg.npz"), distance="l2",
                resolution=8, hyperparameter_search=True, save_plots=False)


@pytest.mark.parametrize("engine,two_pass", [("gemm", False),
                                             ("taps-int8", False),
                                             ("gemm", True)])
def test_fbb_sweep_featurizes_queries_once(tmp_path, monkeypatch, allocs,
                                           engine, two_pass):
    """A two-subdir hyperparameter sweep allocates (and featurises) each
    query cache once; each subdir's results equal a standalone run's and
    the JAX package's ``run_attack`` on the same tree."""
    kw = _write_tree(tmp_path)
    monkeypatch.chdir(tmp_path)
    cfg = AttackConfig(exp_name="sweep", engine=engine, two_pass=two_pass,
                       **kw)
    results = run_attack(cfg, device="cpu")
    assert len(results) == 2
    sweep_allocs = allocs["n"]
    allocs["n"] = 0
    solo = []
    for j in range(2):
        solo.extend(run_attack(replace(
            cfg, hyperparameter_search=False, save_root="solo",
            syn_data_path=os.path.join(kw["syn_data_path"], f"params{j}")),
            device="cpu"))
    # the second subdir reuses every held cache: one query cache (two
    # with two-pass: pass 1's and the re-rank's) fewer than standalone
    assert allocs["n"] - sweep_allocs == (2 if two_pass else 1)
    assert results[1]["plan"]["query_reused"]
    jres = j_run_attack(JAttackConfig(exp_name="sweep_jax", engine=engine,
                                      two_pass=two_pass,
                                      save_root="jax_runs", **kw))
    for r, s, j in zip(results, solo, jres):
        for key in ("pos_nn_idx", "neg_nn_idx"):
            np.testing.assert_array_equal(r[key], s[key])
            np.testing.assert_array_equal(r[key], j[key])
        for key in ("pos_loss", "neg_loss"):
            np.testing.assert_array_equal(r[key], s[key])
            np.testing.assert_allclose(r[key], j[key], rtol=0, atol=1e-5)
        assert r["ingest_s"] >= 0 and r["lpips_init_s"] >= 0 \
            and r["host_copy_s"] >= 0


def test_embed_change_invalidates_query_holders():
    """A new featuriser (here: another engine) drops the held query
    caches — their fingerprints hash the raw images, not the
    embeddings — and the result equals a standalone run's."""
    rng = np.random.default_rng(3)
    syn = rng.integers(0, 256, (20, 8, 8, 3), np.uint8)
    pos = rng.integers(0, 256, (4, 8, 8, 3), np.uint8)
    neg = rng.integers(0, 256, (4, 8, 8, 3), np.uint8)
    base = AttackConfig(distance="l2", resolution=8, save_plots=False)
    cache: dict = {}
    attack_arrays(replace(base, engine="gemm"), syn, pos, neg,
                  device="cpu", sweep_cache=cache)
    held = cache["query_reuse"]["cache"]
    out = attack_arrays(replace(base, engine="exact"), syn, pos, neg,
                        device="cpu", sweep_cache=cache)
    assert cache["embed_key"][0] == "exact"
    assert cache["query_reuse"]["cache"] is not held
    assert not out["plan"]["query_reused"]
    solo = attack_arrays(replace(base, engine="exact"), syn, pos, neg,
                         device="cpu")
    np.testing.assert_array_equal(out["pos_nn_idx"], solo["pos_nn_idx"])
    np.testing.assert_array_equal(out["pos_loss"], solo["pos_loss"])
