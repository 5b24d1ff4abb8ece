"""The sharded layout of the port's multi-GPU kNN (``ganleaks_tpu_torch.
parallel.knn_shard``) on ``gloo`` ranks on the CPU, world sizes 2, 3 and 4
(3 gives shards that do not divide), against the port's single-process
search and the JAX package's mesh search on the 8-device virtual CPU mesh,
after ``tests/test_knn_mesh_streamed.py``: every engine, several chunks
with ties across shards, top-k and the certificate's inputs, the
featurisation work per chunk, a block that does not divide the shard,
two-pass (the certificate, its fallback, pass 1 on every engine),
an OOM forced on one rank only (at each kind of step), query reuse, the
agreed budget.

One ``launch`` per world size runs every case (``torch_rank_workers.
sharded_cases``); the tests assert them one by one. Bars: indices
identical; losses bit-equal to the port's single-process search (each
rank folds its shard with the same blocks and the same query cache) and
within rtol 1e-6 of the JAX mesh search (the bar of
``test_knn_mesh_streamed.py``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import ganleaks_tpu.parallel.knn_shard as jks
import torch_rank_workers as workers
from ganleaks_tpu.ops.distance import make_embed_fn as j_embed_fn
from ganleaks_tpu.ops.distance import make_embed_parts_fn as j_parts_fn
from ganleaks_tpu_torch.ops import knn as tknn
from ganleaks_tpu_torch.ops.distance import make_embed_fn
from ganleaks_tpu_torch.parallel.multihost import launch

SIZES = (2, 3, 4)
ENGINES = workers.ENGINES
RTOL = 1e-6
LAUNCH_S = 120  # every launch's own limit: a deadlock fails the test


def _images(rng, n, hw=8):
    return rng.standard_normal((n, hw, hw, 3)).astype(np.float32)


def _adversarial(far: bool):
    """``test_knn_mesh_streamed._adversarial_sets`` with k = 3."""
    syn = np.zeros((4, 8), np.float32)
    syn[0, 0] = 1.0
    for j in range(3):
        syn[j + 1, 1 + j] = 2.0 if far else 1.0 + 1e-4
    return np.zeros((1, 8), np.float32), syn


def _data() -> dict:
    rng = np.random.default_rng(0)
    data = {"q": _images(rng, 13), "s": _images(rng, 45)}
    tq, ts = _images(rng, 11), _images(rng, 40)
    ts[25] = ts[3]
    ts[39] = ts[3]
    tq[0] = ts[3]
    data.update(tie_q=tq, tie_s=ts, q16=_images(rng, 16),
                s64=_images(rng, 64), q6=_images(rng, 6),
                s36=_images(rng, 36), q7=_images(rng, 7),
                s29=_images(rng, 29), q32=_images(rng, 32),
                s32=_images(rng, 32))
    for name, far in (("adv", False), ("far", True)):
        data[f"{name}_q"], data[f"{name}_s"] = _adversarial(far)
    return data


DATA = _data()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The ranks run torch on one thread each (``launch``'s CPU default):
    the single-process references here do too, since a BLAS product's
    bits may change with its threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"ranks{n}")
def ranks(request):
    out = launch(workers.sharded_cases, request.param, DATA, devices="cpu",
                 timeout_s=LAUNCH_S)
    assert out["size"] == request.param
    return out


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.asarray(jax.devices()[:8]), ("syn",))


def _single(engine, q, s, **kw):
    return tknn.knn_argmin_streamed(workers.embed_for(engine), q, s,
                                    engine=engine, q_block=4, s_block=4, **kw)


_JAX = {}


def _jax(key, fn):
    if key not in _JAX:
        _JAX[key] = tuple(np.asarray(x) for x in fn())
    return _JAX[key]


@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_engine_equals_single_and_jax(ranks, jmesh, engine):
    d, i = ranks[f"argmin_{engine}"]
    d0, i0 = _single(engine, DATA["q"], DATA["s"])
    np.testing.assert_array_equal(i, i0.numpy())
    np.testing.assert_array_equal(d, d0.numpy())
    emb = j_parts_fn("l2") if engine.startswith("taps") else j_embed_fn("l2")
    jd, ji = _jax(("argmin", engine), lambda: jks.knn_argmin_sharded_streamed(
        emb, DATA["q"], DATA["s"], jmesh, engine=engine, q_block=4,
        s_block=4))
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=RTOL)


def test_sharded_multi_chunk_ties_take_the_first_index(ranks):
    d, i = ranks["multi_chunk_ties"]
    assert int(i[0]) == 3  # not 25 / 39: the earliest duplicate
    d0, i0 = tknn.knn_argmin_streamed(
        make_embed_fn("l2"), DATA["tie_q"], DATA["tie_s"], q_block=4,
        s_block=4, query_cache_bytes=8 * 192 * 4)
    np.testing.assert_array_equal(i, i0.numpy())
    np.testing.assert_array_equal(d, d0.numpy())


@pytest.mark.parametrize("engine", ("gemm", "pallas", "taps"))
def test_sharded_topk_equals_single_and_jax(ranks, jmesh, engine):
    td, ti, rq, rs_max = ranks[f"topk_{engine}"]
    ref = tknn.knn_topk_streamed(
        workers.embed_for(engine), DATA["q"], DATA["s"], k=5, engine=engine,
        q_block=4, s_block=4, with_info=True)
    np.testing.assert_array_equal(ti, ref[1].numpy())
    np.testing.assert_array_equal(td, ref[0].numpy())
    np.testing.assert_array_equal(rq, ref[2].numpy())
    jd, ji, info = jks.knn_topk_sharded_streamed(
        j_embed_fn("l2"), DATA["q"], DATA["s"], jmesh, k=5, q_block=4,
        s_block=4, with_info=True)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(td, np.asarray(jd), rtol=RTOL)
    # the certificate's inputs: the largest synthetic norm over the ranks
    np.testing.assert_array_equal(rs_max, ref[3].numpy())
    assert float(rs_max.max()) == pytest.approx(float(info["rs_max"]),
                                                rel=1e-6)
    np.testing.assert_allclose(rq, np.asarray(info["rq"]), rtol=1e-6)


def test_sharded_featurises_each_row_once_per_chunk(ranks):
    """Per rank: one featurisation per query share (16 rows, blocks of
    8) and one per synthetic block of its own shard (blocks of 4)."""
    size = ranks["size"]
    per = -(-(-(-64 // size)) // 4) * 4  # whole blocks of 4
    want = [2 + -(-min(per, max(0, 64 - r * per)) // 4)
            for r in range(size)]
    assert ranks["featurize_calls"] == want


def test_sharded_nondivisor_s_block_exact(ranks, jmesh):
    d, i = ranks["nondivisor"]
    d0, i0 = tknn.knn_argmin_streamed(make_embed_fn("l2"), DATA["q6"],
                                      DATA["s36"], q_block=8, s_block=5)
    np.testing.assert_array_equal(i, i0.numpy())
    np.testing.assert_array_equal(d, d0.numpy())


def test_two_pass_mesh_certificate_and_fallback(ranks, jmesh):
    d, i, cert, n_fb = ranks["two_pass_adv"]
    assert not cert[0] and n_fb == 1
    assert int(i[0]) == 0
    assert float(d[0]) == pytest.approx(1.0, rel=1e-6)
    d2, i2, cert2, n_fb2 = ranks["two_pass_far"]
    assert cert2.all() and n_fb2 == 0 and int(i2[0]) == 0
    jq, js = DATA["adv_q"], DATA["adv_s"]

    def j_lo(x):
        import jax.numpy as jnp
        x = jnp.asarray(x)
        return x * jnp.where((x > 0.9) & (x < 1.1), 1.0 + workers.GAMMA,
                             1.0)

    _, ji, jcert, jn = jks.knn_argmin_two_pass_mesh(
        j_lo, lambda x: x, jq, js, jmesh, k=3, engine="gemm", q_block=8,
        s_block=4, cert_eta=1e-2, return_cert=True)
    np.testing.assert_array_equal(cert, jcert)
    assert n_fb == jn and int(np.asarray(ji)[0]) == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_two_pass_mesh_is_exact(ranks, jmesh, engine):
    d, i, cert, _ = ranks[f"two_pass_{engine}"]
    d0, i0 = tknn.knn_argmin_streamed(make_embed_fn("l2"), DATA["q7"],
                                      DATA["s29"], engine="pallas",
                                      q_block=4, s_block=8)
    np.testing.assert_array_equal(i, i0.numpy())
    np.testing.assert_allclose(d, d0.numpy(), rtol=RTOL)
    lo = j_parts_fn("l2") if engine.startswith("taps") else j_embed_fn("l2")
    jd, ji = _jax(("two_pass", engine), lambda: jks.knn_argmin_two_pass_mesh(
        lo, j_embed_fn("l2"), DATA["q7"], DATA["s29"], jmesh, k=3,
        engine="gemm" if engine == "pallas" else engine, q_block=8,
        s_block=4))
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=RTOL)


def test_oom_on_one_rank_resumes_alike(ranks):
    """The cache allocation fails on rank 0, a query share on the last
    rank, a fold on rank 1 % size: every rank records the same halvings
    and the result is the unforced run's, bit for bit."""
    halvings = ranks["oom_halvings"]
    assert all(h == halvings[0] for h in halvings), halvings
    dims = [h["dim"] for h in halvings[0]]
    # the cache: more chunks, or a smaller block where one block is a
    # chunk (q_block rounds up to whole shares, 18 at three ranks)
    assert dims[0] in ("chunk_rows", "q_block")
    assert dims[1:] == ["q_block", "s_block"]
    for a, b in zip(ranks["oom"], ranks["oom_clean"]):
        np.testing.assert_array_equal(a, b)
    d0, i0 = tknn.knn_argmin_streamed(make_embed_fn("l2"), DATA["q32"],
                                      DATA["s32"], engine="exact",
                                      q_block=16, s_block=8)
    np.testing.assert_array_equal(ranks["oom"][1], i0.numpy())


@pytest.mark.parametrize("site", ("staging", "sweep"))
def test_oom_on_one_rank_at_each_step(ranks, site):
    """The last rank fails staging its first query share for the
    all-gather: every rank halves q_block before the collective. Rank
    1 % size fails twice featurising its first synthetic block: it halves
    s_block alone mid-sweep (no collective there) and the others take its
    s_block at the chunk's end, recording the same halvings. Both
    results are the unforced run's, bit for bit."""
    res, halvings = ranks[f"oom_{site}"]
    assert all(h == halvings[0] for h in halvings), halvings
    want = ([{"dim": "q_block", "to": 8 if ranks["size"] != 3 else 9}]
            if site == "staging" else
            [{"dim": "s_block", "to": 4}, {"dim": "s_block", "to": 2}])
    assert halvings[0] == want
    for a, b in zip(res, ranks["oom_clean"]):
        np.testing.assert_array_equal(a, b)


def test_sharded_query_reuse_on_every_rank(ranks):
    d, i, reused = ranks["reuse"]
    assert reused == [True] * ranks["size"]
    np.testing.assert_array_equal(i, ranks["argmin_gemm"][1])
    np.testing.assert_array_equal(d, ranks["argmin_gemm"][0])


def test_budget_is_agreed_and_split_per_card(ranks):
    """Every rank of a launch shares this host's CPU: each plans from its
    share of the least budget."""
    size = ranks["size"]
    assert ranks["budget"] == [1000 // size] * size
    assert ranks["stats"]["staged_bytes"] == 0  # gloo on CPU tensors
