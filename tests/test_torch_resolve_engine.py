"""``attack/fbb.resolve_auto_engine`` from shapes alone: on CUDA 'auto'
takes the int8 recipe unless a part's int8 cross dot could wrap the int32
accumulator, and it decides that from the parts' shapes without building
a featuriser or reading weights. The reference here is the search's own
check, ``ops/knn._part_bounds_for``, on a featuriser built on the CPU."""

import functools
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


@functools.lru_cache(maxsize=None)
def _built(net: str):
    """The 'taps-int8' featuriser of ``net`` built on the CPU (the seeded
    surrogate backbone with the real lin heads)."""
    cfg = AttackConfig(distance="l2-lpips", lpips_net=net, engine="taps-int8",
                       dtype="bfloat16", lpips_compute_dtype="bfloat16")
    return fbb.build_embed_fn(cfg, "cpu", structured=True)


def _engine_of_built(net: str, res: int, uint8: bool) -> str:
    """What 'auto' resolved to on CUDA when it built the featuriser: the
    search's int32 check on one probe image."""
    probe = np.zeros((1, res, res, 3), np.uint8 if uint8 else np.float32)
    try:
        knn._part_bounds_for(_built(net), probe)
    except ValueError:
        return "taps"
    return "taps-int8"


@pytest.mark.parametrize("uint8", [True, False])
@pytest.mark.parametrize("res", [64, 128, 256, 512])
@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze"])
def test_shape_resolution_equals_the_built_featurisers(net, res, uint8):
    """The shape-only resolution equals the one the built featuriser
    gives; the cases include shapes that degrade to 'taps' (from 256 px
    the pixel part's dot can pass 2^31)."""
    cfg = AttackConfig(distance="l2-lpips", lpips_net=net, resolution=res,
                       uint8_storage=uint8, engine="auto")
    got = fbb.resolve_auto_engine(cfg, "cuda")
    assert got.engine == _engine_of_built(net, res, uint8)
    assert (got.dtype, got.lpips_compute_dtype) == ("bfloat16", "bfloat16")
    assert got.engine == ("taps" if res >= 256 else "taps-int8")


def test_resolution_builds_no_featuriser(monkeypatch, tmp_path):
    """'auto' resolves on a CUDA device string with ``build_embed_fn``
    raising and the weights' npz absent: no featuriser, no weights, no
    probe image."""
    def refuse(*a, **k):
        raise AssertionError("build_embed_fn called")

    monkeypatch.setattr(fbb, "build_embed_fn", refuse)
    missing = str(tmp_path / "absent.npz")
    for res, engine in ((64, "taps-int8"), (256, "taps")):
        for distance in ("l2", "l2-lpips"):
            cfg = AttackConfig(distance=distance, resolution=res,
                               engine="auto", lpips_weights=missing)
            got = fbb.resolve_auto_engine(cfg, "cuda")
            assert (got.engine, got.dtype) == (engine, "bfloat16")


def test_explicit_taps_int8_still_raises_where_it_could_wrap():
    """An explicit 'taps-int8' at the shape where 'auto' degrades raises
    the search's int32-accumulator error; 'auto' at the same shape takes
    'taps' instead."""
    rng = np.random.default_rng(0)
    syn = rng.integers(0, 256, (2, 256, 256, 3), np.uint8)
    pos, neg = syn[:1], syn[1:]
    cfg = AttackConfig(distance="l2", resolution=256, engine="taps-int8",
                       dtype="bfloat16", save_plots=False)
    with pytest.raises(ValueError, match="int32"):
        fbb.attack_arrays(cfg, syn, pos, neg, device="cpu")
    assert fbb.resolve_auto_engine(replace(cfg, engine="auto"),
                                   "cuda").engine == "taps"
