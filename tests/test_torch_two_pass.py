"""The certified two-pass mode and the tap-structured engines of the port
against the JAX package on the CPU: the certificate itself on identical
numpy inputs, ``knn_argmin_two_pass`` for the 'pallas', 'taps' and
'taps-int8' pass-1 engines, ``attack_arrays`` with ``two_pass=True`` and
with each taps engine (the same images and one LPIPS npz through both
packages), and ``resolve_auto_engine``.

Two-pass results are exact float32 searches whatever pass 1 ran in, so
indices must be identical. Losses are rq + rs - 2 q.s in float32: on the
8-px pixel fixtures within rtol 1e-5 plus atol 1e-6; on the 32-px
l2-lpips attacks, where rq + rs is O(1) and each package sums the
128,000-element norms in its own order, within 2e-6 * (rq + rs) (the
deviation measured between the packages here is up to ~1.1e-6). The
single-pass taps engines on float32 towers must return the same indices;
'taps' losses obey the same bound, 'taps-int8' losses 1e-5 * (rq + rs)
(an int8 element can round the other way where the float32 towers differ
in the last bit).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.attack.fbb import attack_arrays as j_attack_arrays
from ganleaks_tpu.config import AttackConfig as JAttackConfig
from ganleaks_tpu.ops import knn as jknn
from ganleaks_tpu.ops.distance import make_embed_fn as j_embed_fn
from ganleaks_tpu.ops.distance import make_embed_parts_fn as j_parts_fn
from ganleaks_tpu.ops.lpips import default_lpips_params, save_lpips_params
from ganleaks_tpu_torch.attack.fbb import (attack_arrays,
                                           resolve_auto_engine)
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.ops import knn as tknn
from ganleaks_tpu_torch.ops.distance import (make_embed_fn,
                                             make_embed_parts_fn)
from ganleaks_tpu_torch.ops.knn_fused import knn_topk_fused

RTOL, ATOL = 1e-5, 1e-6


def test_certificate_equals_jax(rng):
    n = 50
    d_exact = rng.uniform(0.0, 2.0, n)
    topk = np.sort(rng.uniform(0.0, 3.0, (n, 4)), axis=1)
    topk[5, -1] = np.inf  # fewer than k rows: certified
    topk[7, -1] = d_exact[7]  # equal distance outside the union: refused
    rq = rng.uniform(0.0, 4.0, n)
    rq[3] = -1e-7  # rounding below zero clamps to 0
    for eta, abs_err in ((2e-2, 0.0), (1e-6, 0.0), (2e-2, 1e-3)):
        got = tknn.two_pass_certificate(d_exact, topk, rq, 3.5, eta,
                                        abs_err)
        want = jknn.two_pass_certificate(d_exact, topk, rq, 3.5, eta,
                                         abs_err)
        np.testing.assert_array_equal(got, want)
        assert got[5] and not got[7]
    assert 0 < int(got.sum()) < n
    for demoted in (True, False):
        assert tknn._default_cert_eta(demoted) == \
            jknn._default_cert_eta(demoted)
    bounds, shapes = (0.1, 0.02), [(192,), (16, 64)]
    assert tknn._quant_abs_err(bounds, shapes) == \
        jknn._quant_abs_err(bounds, shapes)
    assert tknn._quant_factors(bounds) == jknn._quant_factors(bounds)


def _sets(rng, n_q, n_s, res):
    """Queries whose first third are noisy copies of synthetic rows."""
    s = rng.uniform(-1, 1, (n_s, res, res, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, (n_q, res, res, 3)).astype(np.float32)
    m = n_q // 3
    q[:m] = np.clip(s[:m] + rng.normal(0, 0.05, (m, res, res, 3))
                    .astype(np.float32), -1, 1)
    return q, s


def _two_pass_embeds(torch_side: bool, engine: str):
    """(embed_lo, embed_hi) as the attack builds them for 'l2': bf16
    pass-1 embeddings (parts for the taps engines), float32 re-rank."""
    if torch_side:
        lo = (make_embed_parts_fn if engine.startswith("taps")
              else make_embed_fn)("l2", dtype=torch.bfloat16)
        return lo, make_embed_fn("l2")
    lo = (j_parts_fn if engine.startswith("taps")
          else j_embed_fn)("l2", dtype=jnp.bfloat16)
    return lo, j_embed_fn("l2")


@pytest.mark.parametrize("engine", ["pallas", "taps", "taps-int8"])
def test_two_pass_matches_jax(rng, engine):
    q, s = _sets(rng, 13, 41, 8)
    kw = dict(k=3, engine=engine, q_block=4, s_block=8, return_cert=True)
    d_j, i_j, cert_j, n_j = jknn.knn_argmin_two_pass(
        *_two_pass_embeds(False, engine), jnp.asarray(q), jnp.asarray(s),
        **kw)
    before = knn_topk_fused.launches
    d_t, i_t, cert_t, n_t = tknn.knn_argmin_two_pass(
        *_two_pass_embeds(True, engine), q, s, device="cpu", **kw)
    assert knn_topk_fused.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(i_t[:4].numpy(), np.arange(4))
    # the float32 answer itself
    d0, i0 = tknn.knn_argmin_streamed(make_embed_fn("l2"), q, s,
                                      engine="exact", q_block=4, s_block=8,
                                      device="cpu")
    np.testing.assert_array_equal(i_t.numpy(), i0.numpy())
    assert cert_t.shape == (13,) and n_t == int((~cert_t).sum())
    np.testing.assert_array_equal(cert_t, cert_j)


def test_two_pass_falls_back_where_uncertified(rng, capsys):
    """A tiny k with an eta so wide nothing certifies: every query takes
    the float32 fallback, and the answer is still the exact search."""
    q, s = _sets(rng, 7, 30, 8)
    lo, hi = _two_pass_embeds(True, "pallas")
    d, i, cert, n_fb = tknn.knn_argmin_two_pass(
        lo, hi, q, s, k=1, engine="pallas", q_block=4, s_block=8,
        cert_eta=10.0, return_cert=True, device="cpu")
    assert n_fb == 7 and not cert.any()
    assert "certificate failed for 7 queries" in capsys.readouterr().out
    d0, i0 = tknn.knn_argmin_streamed(hi, q, s, engine="gemm", q_block=4,
                                      s_block=8, device="cpu")
    torch.testing.assert_close(i, i0, rtol=0, atol=0)
    torch.testing.assert_close(d, d0, rtol=1e-6, atol=1e-7)


def test_two_pass_drops_unfilled_slots(rng):
    """Fewer synthetic rows than k: the -1 fill never becomes a
    candidate, and every query certifies (the union is the whole set)."""
    q, s = _sets(rng, 5, 3, 8)
    lo, hi = _two_pass_embeds(True, "taps")
    d, i, cert, n_fb = tknn.knn_argmin_two_pass(
        lo, hi, q, s, k=4, engine="taps", q_block=4, s_block=8,
        return_cert=True, device="cpu")
    assert cert.all() and n_fb == 0
    assert set(i.tolist()) <= {0, 1, 2}


@pytest.fixture
def lpips_npz(tmp_path):
    path = str(tmp_path / "lpips_vgg.npz")
    save_lpips_params(path, default_lpips_params())
    return path


@pytest.fixture
def image_sets(rng):
    """uint8 NHWC sets at 32 px: members are noisy copies of synthetic
    images."""
    syn = rng.integers(0, 256, (20, 32, 32, 3), dtype=np.uint8)
    pos = np.clip(syn[:5].astype(np.int16)
                  + rng.integers(-6, 7, (5, 32, 32, 3)), 0, 255
                  ).astype(np.uint8)
    neg = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    return syn, pos, neg


def _pair_norms(lpips_npz, queries, syn, idx) -> np.ndarray:
    """rq + rs of each query and its chosen row, float32 embeddings."""
    from ganleaks_tpu_torch.attack.fbb import build_embed_fn

    embed = build_embed_fn(AttackConfig(distance="l2-lpips",
                                        lpips_weights=lpips_npz), "cpu")
    with torch.no_grad():
        eq = embed(torch.from_numpy(queries)).double()
        es = embed(torch.from_numpy(syn[idx])).double()
    return ((eq ** 2).sum(1) + (es ** 2).sum(1)).numpy()


@pytest.mark.parametrize("engine,two_pass", [
    ("taps", False), ("taps-int8", False),
    ("taps-int8", True), ("gemm", True),
])
def test_attack_arrays_matches_jax(lpips_npz, image_sets, engine, two_pass):
    syn, pos, neg = image_sets
    kw = dict(distance="l2-lpips", engine=engine, two_pass=two_pass,
              two_pass_k=3, query_block=4, syn_block=8, resolution=32,
              lpips_weights=lpips_npz, save_plots=False)
    rj = j_attack_arrays(JAttackConfig(**kw), syn, pos, neg)
    rt = attack_arrays(AttackConfig(**kw), syn, pos, neg, device="cpu")
    for key in ("pos_nn_idx", "neg_nn_idx"):
        np.testing.assert_array_equal(rt[key], rj[key])
    np.testing.assert_array_equal(rt["pos_nn_idx"], np.arange(5))
    tol = 1e-5 if engine == "taps-int8" and not two_pass else 2e-6
    for key, q in (("pos", pos), ("neg", neg)):
        got, want = rt[f"{key}_loss"], rj[f"{key}_loss"]
        assert got.dtype == np.float64
        norms = _pair_norms(lpips_npz, q, syn, rt[f"{key}_nn_idx"])
        err = np.abs(got - want)
        assert np.all(err <= tol * norms), float((err / norms).max())
    if two_pass:
        assert rt["two_pass_fallbacks"] >= 0
    assert rt["pos_loss"].mean() < rt["neg_loss"].mean()


def test_resolve_auto_engine():
    """CPU: the float32 gemm fold. CUDA: the JAX package's accelerator
    recipe (taps-int8, bf16 embeddings and tower), taps where the int8
    products could wrap. Resolving touches no device, so the CUDA branch
    is checked here too; explicit engines pass through."""
    auto = AttackConfig(engine="auto", distance="l2-lpips")
    cpu = resolve_auto_engine(auto, "cpu")
    assert (cpu.engine, cpu.dtype) == ("gemm", "float32")
    gpu = resolve_auto_engine(auto, "cuda")
    assert (gpu.engine, gpu.dtype, gpu.lpips_compute_dtype) == \
        ("taps-int8", "bfloat16", "bfloat16")
    kept = resolve_auto_engine(
        AttackConfig(engine="auto", lpips_compute_dtype="float32"), "cuda")
    assert kept.lpips_compute_dtype == "float32"
    big = resolve_auto_engine(
        AttackConfig(engine="auto", distance="l2", resolution=256), "cuda")
    assert (big.engine, big.dtype) == ("taps", "bfloat16")
    assert resolve_auto_engine(AttackConfig(engine="exact"),
                               "cuda").engine == "exact"


def test_run_attack_taps_writes_artifacts(lpips_npz, image_sets, tmp_path,
                                          monkeypatch):
    """run_attack with a taps engine writes the reference artifacts."""
    from ganleaks_tpu_torch.attack.fbb import run_attack

    syn, pos, neg = image_sets
    for name, arr in (("syn", syn), ("pos", pos), ("neg", neg)):
        np.savez(tmp_path / f"{name}.npz", images=arr)
    monkeypatch.chdir(tmp_path)
    cfg = AttackConfig(syn_data_path=str(tmp_path / "syn.npz"),
                       pos_data_dir=str(tmp_path / "pos.npz"),
                       neg_data_dir=str(tmp_path / "neg.npz"),
                       resolution=32, engine="taps", two_pass=True,
                       query_block=4, syn_block=8, lpips_weights=lpips_npz,
                       save_plots=False)
    out = run_attack(cfg, device="cpu")[0]
    for f in ("pos_loss.npy", "neg_nn_idx.npy", "params.txt",
              "metrics.jsonl"):
        assert os.path.exists(os.path.join(out["save_dir"], f))
    np.testing.assert_array_equal(out["pos_nn_idx"], np.arange(5))
