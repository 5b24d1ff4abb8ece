"""``ops/knn.search_spec``, the one map from an engine to its search: each
engine's featuriser layout, cache dtype, the planner's charges for its
fold and the two-pass facts, held to a hand-written table, and the one
refusal of an unknown engine that every streamed driver gives, on one
device and on a mesh."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ganleaks_tpu_torch.attack.fbb import build_embed_fn
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.ops import knn
from ganleaks_tpu_torch.ops.stream_plan import FOLD_BYTES_PER_PAIR
from ganleaks_tpu_torch.parallel import knn_shard as ks


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# engine -> (layout, cache dtype, 1-NN fold kind, fused, exact engine);
# "embedded": the featuriser's own dtype
TABLE = {
    "gemm": ("flat", "embedded", "gemm", False, "pallas"),
    "exact": ("flat", "embedded", "gemm", False, "exact"),
    "pallas": ("flat", "embedded", "fused", True, "pallas"),
    "taps": ("parts", "embedded", "fused", True, "pallas"),
    "taps-int8": ("parts", torch.int8, "int8", False, "pallas"),
}
# featuriser -> (AttackConfig fields, resolution, the embedding's dtype, K)
FEATURISERS = {
    "pixel": (dict(distance="l2"), 8, torch.float32, 8 * 8 * 3),
    "lpips": (dict(distance="l2-lpips", lpips_net="vgg", dtype="bfloat16"),
              32, torch.bfloat16, 125 * 32 * 32),
}


@functools.lru_cache(maxsize=None)
def _embed(featuriser: str, structured: bool):
    fields, _, _, _ = FEATURISERS[featuriser]
    return build_embed_fn(AttackConfig(**fields), "cpu",
                          structured=structured)


@pytest.mark.parametrize("featuriser", sorted(FEATURISERS))
@pytest.mark.parametrize("k", [None, 4])
@pytest.mark.parametrize("engine", list(TABLE))
def test_search_spec_table(engine, k, featuriser):
    layout, cache, kind, fused, exact_engine = TABLE[engine]
    _, res, dtype, k_dim = FEATURISERS[featuriser]
    embed = _embed(featuriser, layout == "parts")
    queries = np.zeros((3, res, res, 3), np.uint8)
    spec = knn.search_spec(embed, queries, engine, "cpu",
                           knn.PhaseTimer(torch.device("cpu")), k=k)
    assert spec.signature[0] == layout
    assert spec.cdtype == (dtype if cache == "embedded" else cache)
    assert spec.k_dim == k_dim
    assert spec.row_bytes == k_dim * spec.cdtype.itemsize
    assert spec.charges["fold_bytes_per_pair"] == FOLD_BYTES_PER_PAIR[
        kind if k is None else "topk_" + kind]
    assert spec.charges["state_bytes_per_row"] == (8 if k is None
                                                   else 8 * k + 4)
    assert spec.charges["fused_fold"] is fused
    assert spec.exact_engine == exact_engine
    assert (spec.abs_err > 0) is (cache is torch.int8)
    if k is None and fused:
        assert spec.fold is knn._fold_fused
    # the spec's state holds what its search returns per query row
    state = spec.init_state(4)
    assert [tuple(t.shape) for t in spec.take(state, 3)] == \
        [(3,) if k is None else (3, k)] * 2


MESH = SimpleNamespace(device=torch.device("cpu"))
DRIVERS = {
    "argmin": lambda e, q, s: knn.knn_argmin_streamed(e, q, s,
                                                      engine="bogus"),
    "topk": lambda e, q, s: knn.knn_topk_streamed(e, q, s, k=2,
                                                  engine="bogus"),
    "two_pass": lambda e, q, s: knn.knn_argmin_two_pass(e, e, q, s,
                                                        engine="bogus"),
    "stream_need_bytes": lambda e, q, s: knn.stream_need_bytes(
        e, q, engine="bogus", q_block=2, s_block=2, query_cache_bytes=1,
        auto_plan=True, device=torch.device("cpu")),
    "sharded": lambda e, q, s: ks.knn_argmin_sharded_streamed(
        e, q, s, MESH, engine="bogus"),
    "sharded_topk": lambda e, q, s: ks.knn_topk_sharded_streamed(
        e, q, s, MESH, k=2, engine="bogus"),
    "ring": lambda e, q, s: ks.knn_argmin_ring_streamed(e, q, s, MESH,
                                                        engine="bogus"),
    "two_pass_mesh": lambda e, q, s: ks.knn_argmin_two_pass_mesh(
        e, e, q, s, MESH, engine="bogus"),
}


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_unknown_engine_is_refused_alike(driver):
    """Every driver, single-device or on a mesh, refuses an unknown engine
    with the same error before it featurises or joins a collective."""
    q = np.zeros((2, 8, 8, 3), np.uint8)
    with pytest.raises(ValueError) as err:
        DRIVERS[driver](_embed("pixel", False), q, q)
    assert str(err.value) == (f"unknown kNN engine 'bogus'; expected one "
                              f"of {knn.ENGINES}")
