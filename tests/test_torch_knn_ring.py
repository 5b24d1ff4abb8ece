"""The ring layout and the resident-shard searches of the port's multi-GPU
kNN (``ganleaks_tpu_torch.parallel.knn_shard``) on ``gloo`` ranks on the
CPU, world sizes 2, 3 and 4, against the port's single-process search and
the JAX package's mesh searches on the 8-device virtual CPU mesh, after
``tests/test_knn_mesh_streamed.py`` (the streamed ring per engine, ties
across shards, featurising each row once, an OOM on one rank at each step
of a hop, blocks that do not divide the shards) and ``tests/test_knn_pallas_sharded.py:
58-107`` (the resident sharded and ring searches, the tie-break across
shards).

One ``launch`` per world size runs every case (``torch_rank_workers.
ring_cases``). Bars: indices identical to both packages' searches. The
ring folds each rank's query shard as one cache, so its losses are held
bit for bit to the single-process search of that shard (padded as the
ring pads it): a float32 product's bits may change with the rows beside
it. Against the whole set's single-process search and the JAX ring they
are held within rtol 1e-6 (``test_knn_mesh_streamed.py``'s bar).
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
from ganleaks_tpu.ops.distance import pixel_embedding
from ganleaks_tpu.ops.knn import knn_argmin as j_knn_argmin
from ganleaks_tpu_torch.ops import knn as tknn
from ganleaks_tpu_torch.ops.distance import make_embed_fn
from ganleaks_tpu_torch.parallel.multihost import launch

SIZES = (2, 3, 4)
ENGINES = workers.ENGINES
RTOL = 1e-6
LAUNCH_S = 120


def _images(rng, n, hw=8):
    return rng.standard_normal((n, hw, hw, 3)).astype(np.float32)


def _data() -> dict:
    rng = np.random.default_rng(1)
    data = {"q": _images(rng, 19), "s": _images(rng, 53)}
    tq, ts = _images(rng, 10), _images(rng, 41)
    ts[33] = ts[2]
    ts[40] = ts[2]
    tq[1] = ts[2]
    data.update(tie_q=tq, tie_s=ts, q16=_images(rng, 16),
                s64=_images(rng, 64), q37=_images(rng, 37),
                s37=_images(rng, 37))
    for n_syn in (64, 60):  # even and ragged sharding
        syn = rng.standard_normal((n_syn, 6, 6, 3)).astype(np.float32)
        queries = rng.standard_normal((10, 6, 6, 3)).astype(np.float32)
        syn[40] = queries[2]  # an exact hit in a later shard
        data[f"res{n_syn}_s"], data[f"res{n_syn}_q"] = syn, queries
    syn = rng.standard_normal((32, 10)).astype(np.float32)
    queries = rng.standard_normal((3, 10)).astype(np.float32)
    syn[5] = queries[0]
    syn[29] = queries[0]  # the same distance in a later shard
    data["rt_s"], data["rt_q"] = syn, queries
    for n_syn, n_q in ((64, 16), (57, 11)):
        syn = rng.standard_normal((n_syn, 24)).astype(np.float32)
        queries = rng.standard_normal((n_q, 24)).astype(np.float32)
        syn[50] = queries[1]
        if n_syn > 55:
            syn[55] = queries[1]  # a tie, visited in rotated order
        data[f"rr{n_syn}_s"], data[f"rr{n_syn}_q"] = syn, queries
    return data


DATA = _data()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The ranks run torch on one thread each; so do the references."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"ranks{n}")
def ranks(request):
    out = launch(workers.ring_cases, request.param, DATA, devices="cpu",
                 timeout_s=LAUNCH_S)
    assert out["size"] == request.param
    return out


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.asarray(jax.devices()[:8]), ("syn",))


def _single(engine, q, s, q_block=4, s_block=4):
    return tknn.knn_argmin_streamed(workers.embed_for(engine), q, s,
                                    engine=engine, q_block=q_block,
                                    s_block=s_block)


def _per_shard(engine, q, s, size, q_block=4, s_block=4):
    """The single-process search of each rank's query shard, padded as the
    ring pads it (whole blocks, zero rows at the tail), cut to the set."""
    per = -(-len(q) // size)
    per = -(-per // min(q_block, per)) * min(q_block, per)
    d, i = [], []
    for r in range(size):
        shard = q[r * per:(r + 1) * per]
        if not len(shard):
            continue
        pad = np.zeros((per - len(shard),) + q.shape[1:], q.dtype)
        dr, ir = _single(engine, np.concatenate([shard, pad]), s, q_block,
                         s_block)
        d.append(dr[:len(shard)].numpy())
        i.append(ir[:len(shard)].numpy())
    return np.concatenate(d), np.concatenate(i)


_JAX = {}


@pytest.mark.parametrize("engine", ENGINES)
def test_ring_engine_equals_single_and_jax(ranks, jmesh, engine):
    d, i = ranks[f"ring_{engine}"]
    d0, i0 = _single(engine, DATA["q"], DATA["s"])
    np.testing.assert_array_equal(i, i0.numpy())
    np.testing.assert_allclose(d, d0.numpy(), rtol=RTOL)
    ds, is_ = _per_shard(engine, DATA["q"], DATA["s"], ranks["size"])
    np.testing.assert_array_equal(d, ds)
    np.testing.assert_array_equal(i, is_)
    if engine not in _JAX:
        emb = (j_parts_fn("l2") if engine.startswith("taps")
               else j_embed_fn("l2"))
        _JAX[engine] = [np.asarray(x) for x in jks.knn_argmin_ring_streamed(
            emb, DATA["q"], DATA["s"], jmesh,
            engine="gemm" if engine == "pallas" else engine, q_block=4,
            s_block=4)]
    jd, ji = _JAX[engine]
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=RTOL)


def test_ring_cross_shard_ties_take_the_first_index(ranks):
    d, i = ranks["ring_ties"]
    assert int(i[1]) == 2  # the earliest global duplicate
    _, i0 = _single("gemm", DATA["tie_q"], DATA["tie_s"])
    np.testing.assert_array_equal(i, i0.numpy())


def test_ring_featurises_each_row_once(ranks):
    """Per rank: one featurisation per block of its query shard (blocks
    of 2) and one per block of its HOME synthetic shard (blocks of 4) —
    the embedded blocks rotate, the tower never reruns on a row."""
    size = ranks["size"]
    q_per = -(-16 // size)
    q_per = -(-q_per // 2) * 2
    s_per = -(-(-(-64 // size)) // 4) * 4
    want = [-(-q_per // 2) + -(-min(s_per, max(0, 64 - r * s_per)) // 4)
            for r in range(size)]
    assert ranks["ring_featurize_calls"] == want
    _, i0 = _single("gemm", DATA["q16"], DATA["s64"], 8, 8)
    np.testing.assert_array_equal(ranks["ring_once"][1], i0.numpy())


def test_ring_oom_on_one_rank_resumes_alike(ranks):
    """A fold fails in one rank's hop: every rank gives the step up and
    halves s_block (5 -> 2, no longer dividing the shard); the result is
    the unforced run's, bit for bit, and the single-process indices."""
    halvings = ranks["ring_oom_halvings"]
    assert all(h == halvings[0] for h in halvings), halvings
    assert halvings[0] == [{"dim": "s_block", "to": 2}]
    for a, b in zip(ranks["ring_oom"], ranks["ring_nondivisor"]):
        np.testing.assert_array_equal(a, b)
    d0, i0 = _single("exact", DATA["q37"], DATA["s37"], 5, 5)
    np.testing.assert_array_equal(ranks["ring_oom"][1], i0.numpy())
    np.testing.assert_allclose(ranks["ring_oom"][0], d0.numpy(), rtol=RTOL)


@pytest.mark.parametrize("site", ("featurise", "staging", "landing"))
def test_ring_oom_at_each_step_resumes_alike(ranks, site):
    """The last rank alone runs out of memory featurising a home block,
    staging a hop or landing a received block: every rank raises it at
    the same step, before the next hop, and halves s_block (5 -> 2); the
    result is the unforced run's, bit for bit."""
    res, halvings = ranks[f"ring_oom_{site}"]
    assert halvings == [[{"dim": "s_block", "to": 2}]] * ranks["size"]
    for a, b in zip(res, ranks["ring_nondivisor"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_syn", (64, 60))
def test_resident_sharded_equals_single_device(ranks, jmesh, n_syn):
    d, i = ranks[f"resident_res{n_syn}"]
    syn, queries = DATA[f"res{n_syn}_s"], DATA[f"res{n_syn}_q"]
    embed = make_embed_fn("l2")
    d0, i0 = tknn.knn_argmin(embed(torch.from_numpy(queries)),
                             embed(torch.from_numpy(syn)), s_block=16)
    np.testing.assert_array_equal(i, i0.numpy())
    np.testing.assert_allclose(d, d0.numpy(), rtol=1e-5, atol=1e-6)
    key = f"resident{n_syn}"
    if key not in _JAX:
        _JAX[key] = [np.asarray(x) for x in jks.knn_argmin_sharded(
            j_embed_fn("l2"), queries, syn, jmesh, engine="gemm", q_block=4,
            s_block=4)]
    jd, ji = _JAX[key]
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-6)
    assert int(i[2]) == 40


def test_resident_sharded_tie_break_across_shards(ranks, jmesh):
    d, i = ranks["resident_tie"]
    assert int(i[0]) == 5 and float(d[0]) == 0.0
    if "resident_tie" not in _JAX:
        _JAX["resident_tie"] = np.asarray(jks.knn_argmin_sharded(
            pixel_embedding, DATA["rt_q"], DATA["rt_s"], jmesh,
            engine="exact", q_block=4, s_block=4)[1])
    np.testing.assert_array_equal(i, _JAX["resident_tie"])


@pytest.mark.parametrize("case", ("rr64", "rr57"))
def test_resident_ring_equals_single_device(ranks, case):
    d, i = ranks[f"resident_ring_{case}"]
    syn, queries = DATA[f"{case}_s"], DATA[f"{case}_q"]
    d0, i0 = j_knn_argmin(queries, syn, engine="gemm", s_block=16)
    np.testing.assert_array_equal(i, np.asarray(i0))
    # the exact hits' distances are the cancellation noise of rq + rs -
    # 2 q.s at rq + rs ~ 50 in float32 (a few ulp of 50: ~4e-6 here)
    np.testing.assert_allclose(d, np.asarray(d0), rtol=1e-5, atol=1e-5)
    assert int(i[1]) == 50  # 55 ties it later, in rotated order
