"""The tap-structured parts of the port against the JAX package on the CPU:
``lpips_embed_parts`` (JAX output unpacked from its lane packing),
``quantize_int8``, the static part bounds and the int32 guard, and the
parts searches (``knn_argmin_streamed`` / ``knn_topk_streamed`` on
'taps' and 'taps-int8') in float32, bfloat16 and int8.

Tolerances, with their reasons:
* LPIPS parts: rtol 1e-5 / atol 1e-6, the float32 towers' own difference
  (the two conv implementations sum in different orders);
* searches on pixel parts (identical embeddings on both sides): identical
  indices, distances within rtol 1e-5 / atol 1e-6 (rq + rs - 2 q.s in
  float32 with sums in different orders; int8 cross terms are exact);
* searches on LPIPS parts: identical indices on planted near copies,
  distances within 2e-5 * (rq + rs) — a bf16 or int8 element of a part
  can round the other way where the float32 towers differ in the last
  bit, which moves a distance by far less than that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.ops import knn as jknn
from ganleaks_tpu.ops import lpips as jl
from ganleaks_tpu.ops.distance import make_embed_parts_fn as j_parts_fn
from ganleaks_tpu.ops.distance import quantize_int8 as j_quantize
from ganleaks_tpu.ops.lpips.lpips import (_unpack_lanes, lpips_part_bounds,
                                        lpips_part_int_dot_bounds)
from ganleaks_tpu_torch.device import set_f32_numerics
from ganleaks_tpu_torch.ops import knn as tknn
from ganleaks_tpu_torch.ops import lpips as tl
from ganleaks_tpu_torch.ops.distance import (make_embed_parts_fn,
                                             quantize_int8)
from ganleaks_tpu_torch.weights import lpips_from_jax_params

RTOL, ATOL = 1e-5, 1e-6
J_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np_params(p):
    return {"net": p["net"],
            "convs": [{k: np.asarray(v) for k, v in c.items()}
                      for c in p["convs"]],
            "lins": [np.asarray(w) for w in p["lins"]]}


@pytest.fixture(scope="module")
def shared():
    set_f32_numerics()
    p = jl.default_lpips_params()
    return p, lpips_from_jax_params(_np_params(p)).eval()


def _lpips_embeds(shared, dtype):
    p, model = shared
    port = make_embed_parts_fn(
        "l2-lpips", tl.lpips_embed_parts_fn(model, weight=0.2, dtype=dtype),
        dtype=dtype)
    jax_ = j_parts_fn(
        "l2-lpips", jl.lpips_embed_parts_fn(p, weight=0.2,
                                            dtype=J_DT[dtype]),
        dtype=J_DT[dtype])
    return port, jax_


def _images(rng, n, res):
    return rng.uniform(-1, 1, (n, res, res, 3)).astype(np.float32)


def _planted(rng, n_q, n_s, res, noise=0.02):
    """Queries whose first half are noisy copies of synthetic rows 3.."""
    s = _images(rng, n_s, res)
    q = _images(rng, n_q, res)
    half = n_q // 2
    q[:half] = np.clip(s[3:3 + half] + rng.normal(
        0, noise, (half, res, res, 3)).astype(np.float32), -1, 1)
    return q, s


def test_lpips_embed_parts_matches_jax(shared, rng):
    p, model = shared
    x = _images(rng, 3, 32)
    with torch.no_grad():
        got = tl.lpips_embed_parts(model, torch.from_numpy(x), weight=0.2)
        flat = tl.lpips_embed(model, torch.from_numpy(x), weight=0.2)
    want = jl.lpips_embed_parts(p, jnp.asarray(x), weight=0.2)
    assert len(got) == len(want) == 5
    for g, w, c in zip(got, want, (64, 128, 256, 512, 512)):
        w = np.asarray(_unpack_lanes(w, c, mode="pairs"))
        assert tuple(g.shape) == w.shape and g.shape[2] == c  # (N, HW, C)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    # the parts are the flat embedding's taps, channels last
    torch.testing.assert_close(
        torch.cat([g.reshape(3, -1) for g in got], dim=1), flat,
        rtol=1e-6, atol=1e-9)


def test_quantize_int8_rounds_half_to_even():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, -127.5,
                  300.0, 3.49], np.float32)
    want = np.array([0, 2, 2, 0, -2, -2, 126, 127, -127, 127, 3], np.int8)
    got = quantize_int8(torch.from_numpy(x), 127.0)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(j_quantize(jnp.asarray(x), 127.0)), want)
    # a scale that is not 1: the same float32 product on both sides
    y = np.linspace(-0.06, 0.06, 1001).astype(np.float32)
    np.testing.assert_array_equal(
        quantize_int8(torch.from_numpy(y), 0.06).numpy(),
        np.asarray(j_quantize(jnp.asarray(y), 0.06)))


@pytest.mark.parametrize("res", [16, 32, 64])
def test_part_bounds_match_jax(shared, res):
    p, model = shared
    shape = (res, res, 3)
    assert tl.lpips_part_bounds(model, shape) == lpips_part_bounds(
        p, shape)
    assert tl.lpips_part_int_dot_bounds(model, shape) == \
        lpips_part_int_dot_bounds(p, shape)
    port, jax_ = _lpips_embeds(shared, torch.float32)
    assert port.part_bound_fn(shape) == jax_.part_bound_fn(shape)
    assert port.part_int_dot_bound_fn(shape) == \
        jax_.part_int_dot_bound_fn(shape)
    assert make_embed_parts_fn("l2").part_bound_fn(shape) == \
        j_parts_fn("l2").part_bound_fn(shape)


@pytest.mark.parametrize("res,raises", [(256, True), (64, False)])
def test_part_bounds_for_raises_where_jax_raises(shared, res, raises):
    port, jax_ = _lpips_embeds(shared, torch.float32)
    q = np.zeros((2, res, res, 3), np.float32)
    for t_emb, j_emb in ((make_embed_parts_fn("l2"), j_parts_fn("l2")),
                         (port, jax_)):
        if raises:
            with pytest.raises(ValueError, match="int32"):
                jknn._part_bounds_for(j_emb, jnp.asarray(q))
            with pytest.raises(ValueError, match="int32"):
                tknn._part_bounds_for(t_emb, q)
        else:
            assert tknn._part_bounds_for(t_emb, q) == \
                jknn._part_bounds_for(j_emb, jnp.asarray(q))

    def bare(x):
        return [x.reshape(x.shape[0], -1)]
    with pytest.raises(ValueError, match="part_bound_fn"):
        tknn._part_bounds_for(bare, q)
    with pytest.raises(ValueError, match="part_bound_fn"):
        tknn.knn_argmin_streamed(bare, q, q, engine="taps-int8",
                                 device="cpu")


def test_generic_dot_bound_probes_the_parts():
    """Without ``part_int_dot_bound_fn`` every element is assumed to
    saturate: 127.5^2 per element of each part."""
    def two_parts(x):
        flat = x.reshape(x.shape[0], -1)
        return [flat[:, :100], flat[:, 100:]]
    two_parts.part_bound_fn = lambda shape: [1.0, 1.0]
    assert tknn._part_bounds_for(two_parts, np.zeros((1, 200))) == (1.0, 1.0)
    huge = np.zeros((1, 140000), np.float32)  # 127.5^2 * 139900 > 2^31
    with pytest.raises(ValueError, match="part 1"):
        tknn._part_bounds_for(two_parts, huge)


@pytest.mark.parametrize("engine", ["taps", "taps-int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streamed_parts_pixel_match_jax(rng, engine, dtype):
    """l2 parts: identical embeddings on both sides, so indices are
    identical and distances agree to float32 rounding."""
    q, s = _planted(rng, 9, 37, 8)
    kw = dict(q_block=4, s_block=8)
    d_j, i_j = jknn.knn_argmin_streamed_parts(
        j_parts_fn("l2", dtype=J_DT[dtype]), jnp.asarray(q), jnp.asarray(s),
        quantize=engine == "taps-int8", **kw)
    d_t, i_t = tknn.knn_argmin_streamed(
        make_embed_parts_fn("l2", dtype=dtype), q, s, engine=engine,
        device="cpu", **kw)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(i_t[:4].numpy(), np.arange(3, 7))


@pytest.mark.parametrize("engine", ["taps", "taps-int8"])
def test_streamed_parts_lpips_match_jax(shared, rng, engine):
    """l2-lpips parts in bfloat16 (or int8 from bfloat16) on float32
    towers, query cache in two chunks."""
    port, jax_ = _lpips_embeds(shared, torch.bfloat16)
    q, s = _planted(rng, 6, 20, 32)
    quantize = engine == "taps-int8"
    kw = dict(q_block=2, s_block=8)
    cache = 4 * 125 * 32 * 32 * (1 if quantize else 2)  # 4 rows per chunk
    d_j, i_j = jknn.knn_argmin_streamed_parts(
        jax_, jnp.asarray(q), jnp.asarray(s), query_cache_bytes=cache,
        quantize=quantize, **kw)
    d_t, i_t = tknn.knn_argmin_streamed(
        port, q, s, query_cache_bytes=cache, engine=engine, device="cpu",
        **kw)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(i_t[:3].numpy(), np.arange(3, 6))
    with torch.no_grad():
        flat = torch.cat([p.reshape(len(q), -1).double()
                          for p in port(torch.from_numpy(q))], 1)
        flat_s = torch.cat([p.reshape(len(s), -1).double()
                            for p in port(torch.from_numpy(s))], 1)
    scale = ((flat ** 2).sum(1)
             + (flat_s[i_t.long()] ** 2).sum(1)).numpy()
    err = np.abs(d_t.numpy() - np.asarray(d_j))
    assert np.all(err <= 2e-5 * scale), float((err / scale).max())


@pytest.mark.parametrize("engine", ["taps", "taps-int8"])
def test_topk_streamed_parts_match_jax(rng, engine):
    q, s = _planted(rng, 9, 37, 8)
    kw = dict(k=3, q_block=4, s_block=8, with_info=True)
    d_j, i_j, rq_j, rs_j = jknn.knn_topk_streamed_parts(
        j_parts_fn("l2"), jnp.asarray(q), jnp.asarray(s),
        quantize=engine == "taps-int8", **kw)
    d_t, i_t, rq_t, rs_t = tknn.knn_topk_streamed(
        make_embed_parts_fn("l2"), q, s, engine=engine, device="cpu", **kw)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(rq_t.numpy(), np.asarray(rq_j), rtol=1e-6)
    np.testing.assert_allclose(float(rs_t.max()), float(np.max(rs_j)),
                               rtol=1e-6)


@pytest.mark.parametrize("cdtype,quant", [(torch.float32, False),
                                          (torch.bfloat16, False),
                                          (torch.bfloat16, True)])
def test_fused_featuriser_equals_parts(shared, rng, cdtype, quant):
    """The fused featuriser (taps through the tap epilogue) writes the
    same buffer as flattening and concatenating the plain parts, bit for
    bit, with the same norms up to their summation order."""
    port, _ = _lpips_embeds(shared, cdtype)
    x = torch.from_numpy(_images(rng, 3, 32))
    bounds = tknn._part_bounds_for(port, x) if quant else None
    res_dtype = torch.int8 if quant else cdtype
    fused = tknn._fused_parts_norms(port, res_dtype, bounds)

    def plain(blk):  # the same parts without the fused featuriser
        return port(blk)
    slow = tknn._fused_parts_norms(plain, res_dtype, bounds)
    with torch.no_grad():
        flat_f, r_f, w_f = fused(x)
        flat_s, r_s, w_s = slow(x)
    assert w_f == w_s and flat_f.dtype == res_dtype
    assert w_f[0] == 3 * 32 * 32 and sum(w_f) == 125 * 32 * 32
    torch.testing.assert_close(flat_f, flat_s, rtol=0, atol=0)
    torch.testing.assert_close(r_f, r_s, rtol=1e-6, atol=0)


def test_int8_fold_dequantises_each_part():
    """The int8 fold: per-part s8 x s8 -> s32 products scaled by
    (bound/127)^2, summed, masked past n_valid, first index on ties."""
    q = torch.tensor([[10, -3, 7], [0, 0, 1]], dtype=torch.int8)
    s = torch.tensor([[10, -3, 7], [1, 2, 3], [10, -3, 7], [9, 9, 9]],
                     dtype=torch.int8)
    widths, bounds = (2, 1), (2.0, 0.5)
    f = tknn._quant_factors(bounds)
    rq = torch.tensor([1.0, 2.0])
    rs = torch.tensor([1.0, 0.5, 1.0, -100.0])  # row 3: padding, masked
    run = (torch.full((2,), torch.inf), torch.zeros(2, dtype=torch.int32))
    d, i = tknn._fold_block_parts_q(*run, q, rq, s, rs, 40, 3, widths, f)
    cross = (q[:, :2].double() @ s[:, :2].double().T * f[0]
             + q[:, 2:].double() @ s[:, 2:].double().T * f[1])
    full = rq[:, None].double() + rs[None, :].double() - 2 * cross
    want = full[:, :3].min(1)
    np.testing.assert_allclose(d.numpy(), want.values.numpy(), rtol=1e-6)
    assert i.tolist() == [40 + int(want.indices[0]), 40 + int(
        want.indices[1])]
    # rows 0 and 2 are equal: an equal later row never takes over
    d2, i2 = tknn._fold_block_parts_q(d, i, q, rq, s[2:3], rs[2:3], 50, 1,
                                      widths, f)
    assert i2.tolist() == i.tolist()
