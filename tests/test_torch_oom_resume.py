"""The port's OOM-halving resume (``ganleaks_tpu_torch.ops.knn.
_stream_search``), after ``tests/test_knn_oom_resume.py``: a
``torch.cuda.OutOfMemoryError`` halves only the dimension that failed and
the search goes on from where it was — finished synthetic blocks are not
featurised again, the running state survives, the query cache is kept.

Failures are injected from an eager embed mock (the TPU package's
schedule: the first call after the shape probe is the first query block)
and from a fold hook; every result is held equal to a clean run of the
port and to the JAX package's ``knn_argmin_streamed`` / ``knn_topk_
streamed`` on the same numpy inputs (identical indices, losses within
rtol 1e-5). Rows are identity-tagged: row r of a set is the constant
``tag + r + 1``, so the first value of a block names the rows it holds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.ops import knn as jknn
from ganleaks_tpu.ops.distance import make_embed_fn as j_make_embed_fn
from ganleaks_tpu_torch.ops import knn
from ganleaks_tpu_torch.ops.distance import make_embed_fn

RTOL = 1e-5
OOM = torch.cuda.OutOfMemoryError


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class InjectingEmbed:
    """Flattening l2 embed (``make_embed_fn('l2')``'s arithmetic) that
    raises an OOM on chosen call numbers — counted after the search's
    one-image shape probe — and logs (first-row id, rows) of every
    successful call."""

    def __init__(self, fail_on_calls=()):
        self.calls = 0
        self.probed = False
        self.fail_on = set(fail_on_calls)
        self.log: list[tuple[float, int]] = []

    def __call__(self, x):
        flat = x.reshape(x.shape[0], -1).float()
        out = flat * (1.0 / float(np.sqrt(flat.shape[1])))
        if not self.probed:
            self.probed = True
            return out
        self.calls += 1
        if self.calls in self.fail_on:
            raise OOM("CUDA out of memory (injected)")
        self.log.append((float(x[0, 0, 0, 0]), int(x.shape[0])))
        return out


def tagged(n: int, tag: float) -> np.ndarray:
    """(n, 2, 2, 1) array whose row r is constant tag + r + 1."""
    return (tag + np.arange(1, n + 1, dtype=np.float32)
            ).reshape(n, 1, 1, 1) * np.ones((1, 2, 2, 1), np.float32)


def coverage(log, tag, total):
    """Rows featurised (by first-row id and count), as a sorted list of
    row indices relative to ``tag`` (zero-padded tails drop out)."""
    rows = []
    for first, n in log:
        if not (tag < first <= tag + total):
            continue
        start = int(round(first - tag)) - 1
        rows.extend(range(start, min(start + n, total)))
    return sorted(rows)


def clean(queries, syn, **kw):
    d, i = knn.knn_argmin_streamed(make_embed_fn("l2"), queries, syn,
                                   s_block=kw.pop("s_block", 8),
                                   q_block=kw.pop("q_block", 4), **kw)
    return d.numpy(), i.numpy()


def jax_result(queries, syn, topk=None, q_block=4, s_block=8):
    embed = j_make_embed_fn("l2")
    if topk:
        d, i = jknn.knn_topk_streamed(embed, jnp.asarray(queries),
                                      jnp.asarray(syn), k=topk,
                                      s_block=s_block, q_block=q_block)
    else:
        d, i = jknn.knn_argmin_streamed(embed, jnp.asarray(queries),
                                        jnp.asarray(syn), s_block=s_block,
                                        q_block=q_block)
    return np.asarray(d), np.asarray(i)


def assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got[1]), want[1])
    np.testing.assert_allclose(np.asarray(got[0]), want[0], rtol=RTOL)


def test_syn_oom_resumes_without_recompute():
    queries, syn = tagged(4, 1000.0), tagged(32, 0.0)
    # call 1 = query block; calls 2, 3 = syn rows 0-8, 8-16; call 4 (rows
    # 16-24) raises -> s_block 8 -> 4, resume at row 16
    embed = InjectingEmbed(fail_on_calls=(4,))
    info: dict = {}
    d, i = knn.knn_argmin_streamed(embed, queries, syn, s_block=8,
                                   q_block=4, info=info)
    assert_same((d, i), clean(queries, syn))
    assert_same((d, i), jax_result(queries, syn))
    assert coverage(embed.log, 0.0, 32) == list(range(32)), \
        "every synthetic row featurised exactly once (no recompute)"
    assert coverage(embed.log, 1000.0, 4) == list(range(4)), \
        "the query cache survived the synthetic-stream OOM"
    assert info["oom_resumes"] == 1
    assert info["halvings"] == [{"dim": "s_block", "to": 4}]
    assert (info["s_block"], info["sweeps"]) == (4, 1)


def test_query_oom_halves_q_block_keeps_parts():
    queries, syn = tagged(8, 1000.0), tagged(16, 0.0)
    # call 1 = query rows 0-4; call 2 (rows 4-8) raises -> q_block 2,
    # resume at query row 4
    embed = InjectingEmbed(fail_on_calls=(2,))
    info: dict = {}
    out = knn.knn_argmin_streamed(embed, queries, syn, s_block=8, q_block=4,
                                  info=info)
    assert_same(out, clean(queries, syn))
    assert_same(out, jax_result(queries, syn))
    assert coverage(embed.log, 1000.0, 8) == list(range(8)), \
        "finished query blocks kept; only the failed block walked again"
    assert coverage(embed.log, 0.0, 16) == list(range(16))
    assert info["halvings"] == [{"dim": "q_block", "to": 2}]


def test_query_oom_non_dividing_halving_no_clamp_corruption():
    """q_block halving to a size that does NOT divide the rest of the
    chunk (5 -> 2 over 10 rows): the last write is capped at the cache's
    end and overwrites no featurised row."""
    queries, syn = tagged(10, 1000.0), tagged(32, 0.0)
    want = clean(queries, syn, q_block=5)
    inj = InjectingEmbed(fail_on_calls=(2,))  # rows 5-10 fail -> q_block 2
    out = knn.knn_argmin_streamed(inj, queries, syn, s_block=8, q_block=5)
    assert_same(out, want)
    assert_same(out, jax_result(queries, syn, q_block=5))
    assert coverage(inj.log, 1000.0, 10) == list(range(10)), \
        "every query row featurised once despite the non-dividing halving"


@pytest.mark.parametrize("err", [ValueError("not an oom"),
                                 RuntimeError("CUDA error: an illegal "
                                              "memory access")])
def test_non_oom_errors_propagate(err):
    class Boom(InjectingEmbed):
        def __call__(self, x):
            out = super().__call__(x)
            if self.calls:
                raise err
            return out

    with pytest.raises(type(err), match=str(err)):
        knn.knn_argmin_streamed(Boom(), tagged(4, 0.0), tagged(8, 100.0),
                                s_block=4, q_block=4)


def test_topk_oom_resumes_like_argmin():
    queries, syn = tagged(4, 1000.0), tagged(32, 0.0)
    embed = make_embed_fn("l2")
    want = knn.knn_topk_streamed(embed, queries, syn, k=3, s_block=8,
                                 q_block=4)
    inj = InjectingEmbed(fail_on_calls=(4,))  # the third syn block raises
    d, i = knn.knn_topk_streamed(inj, queries, syn, k=3, s_block=8,
                                 q_block=4)
    assert_same((d, i), (want[0].numpy(), want[1].numpy()))
    assert_same((d, i), jax_result(queries, syn, topk=3))
    assert coverage(inj.log, 0.0, 32) == list(range(32))


def test_syn_oom_at_min_block_shrinks_cache_and_restarts_chunk():
    """s_block bottoms out at 1 and the OOM persists: the pressure is the
    resident query cache, so chunk_rows halves and the chunk restarts (more
    sweeps) instead of raising."""
    queries, syn = tagged(8, 1000.0), tagged(8, 0.0)
    want = clean(queries, syn, s_block=2)
    # the cache holds exactly the 8 rows (16 bytes each); calls 1, 2 fill
    # it, call 3 (the first syn block at s_block 2) raises -> s_block 1,
    # call 4 raises -> chunk_rows 4, the chunk restarts at s_block 2 and
    # the search ends as two 4-row chunks
    embed = InjectingEmbed(fail_on_calls=(3, 4))
    info: dict = {}
    out = knn.knn_argmin_streamed(embed, queries, syn, s_block=2, q_block=4,
                                  query_cache_bytes=8 * 16, info=info)
    assert_same(out, want)
    assert_same(out, jax_result(queries, syn, s_block=2))
    assert coverage(embed.log, 0.0, 8) == sorted(list(range(8)) * 2), \
        "each halved chunk sweeps the whole synthetic set once"
    assert coverage(embed.log, 1000.0, 8) == sorted(list(range(8)) * 2), \
        "the restart featurises the chunk's rows once more"
    assert [h["dim"] for h in info["halvings"]] == ["s_block", "chunk_rows"]
    assert info["sweeps"] == 2


def test_oom_at_minimum_block_reraises():
    embed = InjectingEmbed(fail_on_calls=set(range(1, 50)))
    with pytest.raises(OOM):
        knn.knn_argmin_streamed(embed, tagged(4, 1000.0), tagged(8, 0.0),
                                s_block=8, q_block=8)


def test_randomized_oom_schedules_match_clean():
    """Any one or two failures at random calls leave the result equal to
    the clean run's (the tests above pin where the resume acts; this one
    that no schedule corrupts the fold)."""
    rng = np.random.default_rng(7)
    queries, syn = tagged(10, 1000.0), tagged(37, 0.0)  # non-dividing
    want = clean(queries, syn)
    assert_same(want, jax_result(queries, syn))
    for _ in range(12):
        fail_on = set(rng.integers(1, 40,
                                   size=int(rng.integers(1, 3))).tolist())
        embed = InjectingEmbed(fail_on_calls=fail_on)
        d, i = knn.knn_argmin_streamed(embed, queries, syn, s_block=8,
                                       q_block=4)
        np.testing.assert_array_equal(i.numpy(), want[1],
                                      err_msg=f"fail_on={sorted(fail_on)}")
        np.testing.assert_allclose(d.numpy(), want[0], rtol=RTOL,
                                   err_msg=f"fail_on={sorted(fail_on)}")


def test_fold_oom_resumes_at_the_failed_block(monkeypatch):
    """An OOM raised by the fold (after its block was featurised) halves
    s_block and goes on at that block with the running state: only the
    failed block's rows are featurised again."""
    queries, syn = tagged(4, 1000.0), tagged(32, 0.0)
    want = clean(queries, syn)
    real, calls = knn._fold_block, {"n": 0}

    def failing_fold(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:  # the fold of syn rows 16-24
            raise OOM("CUDA out of memory (injected fold)")
        return real(*a, **kw)

    monkeypatch.setattr(knn, "_fold_block", failing_fold)
    embed = InjectingEmbed()
    info: dict = {}
    out = knn.knn_argmin_streamed(embed, queries, syn, s_block=8, q_block=4,
                                  info=info)
    assert_same(out, want)
    assert_same(out, jax_result(queries, syn))
    assert coverage(embed.log, 0.0, 32) == sorted(
        list(range(32)) + list(range(16, 24)))
    assert info["halvings"] == [{"dim": "s_block", "to": 4}]


def test_cache_alloc_oom_shrinks_q_block_when_chunk_at_floor(monkeypatch):
    """The cache allocation fails: chunk_rows halves; at one q_block per
    chunk, q_block itself halves — and the results equal the clean run."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((16, 8)).astype(np.float32)
    s = rng.standard_normal((40, 8)).astype(np.float32)
    embed = make_embed_fn("l2")
    want = clean(q, s, q_block=8, s_block=8)
    fails = {"n": 2}
    real = knn._alloc_cache

    def failing_alloc(padded, *a):
        if fails["n"] and padded >= 8:
            fails["n"] -= 1
            raise OOM("CUDA out of memory (injected alloc)")
        return real(padded, *a)

    monkeypatch.setattr(knn, "_alloc_cache", failing_alloc)
    info: dict = {}
    # the cache fits one 16-row chunk: fail 1 halves chunk_rows to
    # q_block (8), fail 2 hits the floor -> q_block 4
    out = knn.knn_argmin_streamed(embed, q, s, q_block=8, s_block=8,
                                  query_cache_bytes=16 * 32, info=info)
    assert fails["n"] == 0, "both injected failures fired"
    assert_same(out, want)
    assert_same(out, jax_result(q, s, q_block=8, s_block=8))
    assert info["halvings"] == [{"dim": "chunk_rows", "to": 8},
                                {"dim": "q_block", "to": 4}]


def test_recovery_drops_held_caches(monkeypatch):
    """A held reuse cache (own or a sibling's) is device memory the retry
    needs back: the recovery drops it."""
    queries, syn = tagged(8, 1000.0), tagged(16, 0.0)
    own, sibling = {}, {"fp": "stale", "cache": torch.zeros(4)}
    embed = InjectingEmbed(fail_on_calls=(2,))  # a query block fails
    knn.knn_argmin_streamed(embed, queries, syn, s_block=8, q_block=4,
                            query_reuse=own, reuse_siblings=(sibling,))
    assert sibling == {}
    assert own["fp"][0] == 8, "the finished one-chunk cache is held"


def test_attack_arrays_reports_oom_resumes(monkeypatch):
    from ganleaks_tpu_torch.attack.fbb import attack_arrays
    from ganleaks_tpu_torch.config import AttackConfig

    imgs = np.random.default_rng(3).integers(0, 256, (12, 8, 8, 3),
                                             np.uint8)
    cfg = AttackConfig(distance="l2", resolution=8, query_block=4,
                       syn_block=4)
    want = attack_arrays(cfg, imgs, imgs[:3], imgs[3:6], device="cpu")
    assert want["oom_resumes"] == 0
    real, fails = knn._alloc_cache, {"n": 1}

    def failing_alloc(*a):
        if fails["n"]:
            fails["n"] -= 1
            raise OOM("CUDA out of memory (injected alloc)")
        return real(*a)

    monkeypatch.setattr(knn, "_alloc_cache", failing_alloc)
    got = attack_arrays(cfg, imgs, imgs[:3], imgs[3:6], device="cpu")
    assert got["oom_resumes"] == 1
    for key in ("pos_nn_idx", "neg_nn_idx", "pos_loss", "neg_loss"):
        np.testing.assert_array_equal(got[key], want[key])
