"""Queries a held cache covers are neither joined nor staged
(``attack/fbb._query_rows``, ``ops/knn.JoinedRows``): a single-device
one-pass ``attack_arrays`` call whose ``sweep_cache`` holds the cache of
its pos and neg reads them in place, and its results equal those of a
call without a ``sweep_cache`` bit for bit; a changed query set, or
another path, joins and stages them as before. The in-place fingerprint
is the joined array's."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from ganleaks_tpu_torch.attack import fbb
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.ops import knn


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def staged(monkeypatch):
    """The type of the queries each ``_stage_sets`` call was handed."""
    seen = []
    real = fbb._stage_sets

    def spy(cfg, embed, queries, *a, **k):
        seen.append(type(queries))
        return real(cfg, embed, queries, *a, **k)

    monkeypatch.setattr(fbb, "_stage_sets", spy)
    return seen


def _sets(res=8, n_syn=40, n_pos=7, n_neg=5, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 256, (n, res, res, 3), np.uint8)
                 for n in (n_syn, n_pos, n_neg))


def _folds(cfg) -> dict:
    """The fold counters of one call over ``_sets``' 40 synthetic rows:
    5 blocks, in the int8 fold kernel's route for the int8 engines (every
    part width a multiple of 32)."""
    return {"int8_fold_kernel_blocks":
            5 if cfg.engine == "taps-int8" else 0,
            "int8_fold_parts_blocks": 0}


def _tower(cfg, blocks: int) -> dict:
    """The tower counters of a call that featurised ``blocks`` blocks:
    VGG16's 13 convolutions a block through the PyTorch ops on the CPU
    (the kernel's pass runs on the card only), none without LPIPS."""
    lpips = cfg.distance == "l2-lpips"
    return {"tower_epilogue_kernel_convs": 0,
            "tower_epilogue_plain_convs": 13 * blocks if lpips else 0}


def _eq(out, ref):
    for key in ("pos_loss", "neg_loss", "pos_nn_idx", "neg_nn_idx"):
        np.testing.assert_array_equal(out[key], ref[key])


CASES = {
    "gemm": AttackConfig(distance="l2", resolution=8, engine="gemm",
                         query_block=4, syn_block=8, save_plots=False),
    "taps-int8": AttackConfig(distance="l2", resolution=8,
                              engine="taps-int8", dtype="bfloat16",
                              query_block=4, syn_block=8, save_plots=False),
    "lpips-taps-int8": AttackConfig(
        distance="l2-lpips", resolution=32, engine="taps-int8",
        dtype="bfloat16", lpips_compute_dtype="bfloat16", query_block=4,
        syn_block=8, save_plots=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_held_queries_are_not_staged(staged, case):
    """Two calls sharing one ``sweep_cache`` and the same pos and neg:
    both equal a call without one; the second joins and stages no query
    row (the search reads them in place and serves every row from the
    cache)."""
    cfg = CASES[case]
    syn, pos, neg = _sets(res=cfg.resolution)
    n_q = len(pos) + len(neg)
    ref = fbb.attack_arrays(cfg, syn, pos, neg, device="cpu")
    cache: dict = {}
    staged.clear()
    first = fbb.attack_arrays(cfg, syn, pos, neg, device="cpu",
                              sweep_cache=cache)
    second = fbb.attack_arrays(cfg, syn, pos, neg, device="cpu",
                               sweep_cache=cache)
    _eq(first, ref)
    _eq(second, ref)
    assert staged == [np.ndarray, knn.JoinedRows]
    assert first["counters"]["query_rows_staged"] == n_q
    assert second["counters"] == {"query_rows_featurised": 0,
                                  "query_rows_reused": n_q,
                                  "query_rows_staged": 0, **_folds(cfg),
                                  **_tower(cfg, 5)}


def test_changed_middle_row_is_featurised_and_staged(staged):
    """A copy of pos with one middle row changed misses the held cache:
    the call joins, stages and featurises every query row, and equals a
    call without a ``sweep_cache``."""
    cfg = CASES["taps-int8"]
    syn, pos, neg = _sets()
    n_q = len(pos) + len(neg)
    cache: dict = {}
    fbb.attack_arrays(cfg, syn, pos, neg, device="cpu", sweep_cache=cache)
    changed = pos.copy()
    changed[len(pos) // 2] = 255 - changed[len(pos) // 2]
    staged.clear()
    out = fbb.attack_arrays(cfg, syn, changed, neg, device="cpu",
                            sweep_cache=cache)
    assert staged == [np.ndarray]
    assert out["counters"] == {"query_rows_featurised": n_q,
                               "query_rows_reused": 0,
                               "query_rows_staged": n_q, **_folds(cfg),
                               **_tower(cfg, 3 + 5)}
    _eq(out, fbb.attack_arrays(cfg, syn, changed, neg, device="cpu"))


@pytest.mark.parametrize("path", ["two_pass", "no_cache"])
def test_other_paths_join_the_queries(staged, path):
    """Without a ``sweep_cache``, or on the two-pass path (its holders
    are pass 1's and the re-rank's), every call joins and stages its
    queries as before."""
    cfg = replace(CASES["gemm"], two_pass=path == "two_pass", two_pass_k=2)
    syn, pos, neg = _sets()
    cache = {} if path == "two_pass" else None
    outs = [fbb.attack_arrays(cfg, syn, pos, neg, device="cpu",
                              sweep_cache=cache) for _ in range(2)]
    assert staged == [np.ndarray, np.ndarray]
    assert [o["counters"]["query_rows_staged"] for o in outs] == \
        [len(pos) + len(neg)] * 2
    _eq(outs[1], outs[0])


@pytest.mark.parametrize("n_pos,n_neg", [(1, 1), (3, 5), (0, 6), (40, 23),
                                         (64, 1), (100, 157)])
def test_in_place_fingerprint_is_the_joined_arrays(n_pos, n_neg):
    """The fingerprint of pos and neg read in place equals the joined
    array's, for sets smaller and larger than the 64 strided rows; so do
    slices and the shape, dtype and bytes the search reads."""
    rng = np.random.default_rng(n_pos * 1000 + n_neg)
    pos = rng.integers(0, 256, (n_pos, 4, 4, 3), np.uint8)
    neg = rng.integers(0, 256, (n_neg, 4, 4, 3), np.uint8)
    joined = np.concatenate([pos, neg])
    rows = knn.JoinedRows(pos, neg)
    sig = (("parts", (48,), "torch.bfloat16", (0.5,)), "torch.int8", 48)
    assert knn._fingerprint(rows, sig) == knn._fingerprint(joined, sig)
    assert (len(rows), rows.shape, rows.dtype, rows.nbytes) == \
        (len(joined), joined.shape, joined.dtype, joined.nbytes)
    for lo, hi in ((0, 1), (0, len(joined)), (max(0, n_pos - 2), n_pos + 2),
                   (n_pos, len(joined) + 5)):
        np.testing.assert_array_equal(rows[lo:hi], joined[lo:hi])
    held = {"fp": knn._fingerprint(joined, sig)}
    assert knn.holds_queries(held, rows)
    if n_pos > 1:
        other = pos.copy()
        other[n_pos // 2] ^= 1
        assert knn.holds_queries(held, knn.JoinedRows(other, neg)) == \
            (knn._fingerprint(np.concatenate([other, neg]), sig)
             == held["fp"])


def test_joined_rows_take_the_joined_dtype():
    """Sets of two dtypes read as ``np.concatenate`` joins them."""
    pos = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    neg = np.linspace(-1, 1, 36, dtype=np.float32).reshape(3, 4, 3)
    joined = np.concatenate([pos, neg])
    rows = knn.JoinedRows(pos, neg)
    assert rows.dtype == joined.dtype and rows.nbytes == joined.nbytes
    np.testing.assert_array_equal(rows[1:4], joined[1:4])
    np.testing.assert_array_equal(rows[np.asarray([0, 2, 4])],
                                  joined[[0, 2, 4]])
