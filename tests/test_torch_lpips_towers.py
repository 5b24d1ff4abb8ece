"""The AlexNet, SqueezeNet1.1 and ResNet18 LPIPS towers of the port against
the JAX package on the CPU (mirrors ``tests/test_lpips_backbones_extra.py``).

Weights go across with ``weights.lpips_from_jax_params``; inputs come from
a numpy seed. Bars:

* ``lpips_pair`` and ``pnet_pair``: rtol 1e-5, atol 1e-6 (float32, TF32
  off; the two conv implementations sum in different orders), as
  ``tests/test_torch_lpips.py`` holds VGG16; the raw taps the same, with
  atol scaled by the tap's largest value where that exceeds 1;
* the converter: vgg/alex/squeeze kernels equal the JAX converter's bit
  for bit; resnet18's BatchNorm fold runs in float64 and rounds once, so
  it equals that rounding exactly and the JAX float32 fold within
  rtol 1e-6;
* K2's plain version on the alex/squeeze taps: bit for bit against the
  JAX Pallas kernel in interpret mode, or, for taps outside that kernel's
  lane envelope (odd P at C = 64, C = 192), against the XLA math the JAX
  featuriser uses for them;
* the fbb attack on the alex tower ('gemm', 'taps', 'taps-int8'): indices
  equal, losses within rtol 1e-5 plus atol 1e-6, AUROC within 1e-6, as
  ``tests/test_torch_pipeline_e2e.py`` holds VGG16.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganleaks_tpu.attack.eval_roc import evaluate as j_evaluate
from ganleaks_tpu.attack.fbb import run_attack as j_run_attack
from ganleaks_tpu.config import AttackConfig as JAttackConfig
from ganleaks_tpu.config import EvalConfig as JEvalConfig
from ganleaks_tpu.ops import lpips as jl
from ganleaks_tpu.ops.distance import quantize_int8 as j_quantize_int8
from ganleaks_tpu.ops.lpips.epilogue_pallas import tap_epilogue as j_tap
from ganleaks_tpu.ops.lpips.lpips import _features as j_features
from ganleaks_tpu.ops.lpips.lpips import _pack_lanes, _unpack_lanes
from ganleaks_tpu.tools import convert_lpips as jconv
from ganleaks_tpu_torch.attack.eval_roc import evaluate
from ganleaks_tpu_torch.attack.fbb import run_attack
from ganleaks_tpu_torch.config import AttackConfig, EvalConfig
from ganleaks_tpu_torch.device import set_f32_numerics
from ganleaks_tpu_torch.ops import lpips as tl
from ganleaks_tpu_torch.ops.lpips.backbones import (ALEXNET_CHNS,
                                                    RESNET18_CHNS,
                                                    SQUEEZE_CHNS, Tower,
                                                    backbone_channels,
                                                    tap_shapes)
from ganleaks_tpu_torch.ops.lpips.epilogue import tap_epilogue
from ganleaks_tpu_torch.ops.lpips.lpips import (_tap_scale,
                                                lpips_part_int_dot_bounds)
from ganleaks_tpu_torch.tools import convert_lpips as tconv
from ganleaks_tpu_torch.weights import lpips_from_jax_params
from tests.test_lpips_backbones_extra import (_resnet_state_dict,
                                              _squeeze_state_dict,
                                              _torch_resnet_taps,
                                              _torch_squeeze_taps)

RTOL, ATOL = 1e-5, 1e-6
NETS = ("alex", "squeeze", "resnet")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several processes at once; torch's CPU thread
    pool in each of them, on top of the others, slows every process many
    times over. One thread per process for this module's convolutions."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    set_f32_numerics()
    yield
    torch.set_num_threads(before)


def _np_params(p):
    return {"net": p["net"],
            "convs": [{k: np.asarray(v) for k, v in c.items()}
                      for c in p["convs"]],
            "lins": [np.asarray(w) for w in p["lins"]]}


@pytest.fixture(scope="module")
def shared():
    """net -> (JAX params, the port's module on the same weights)."""
    out = {}
    for net in NETS:
        p = jl.init_lpips_params(seed=3, net=net)
        out[net] = (p, lpips_from_jax_params(_np_params(p)).eval())
    return out


def _images(seed, n=2, res=64):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, res, res, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def test_backbone_channels_all_nets():
    assert backbone_channels("vgg") == backbone_channels("vgg16") \
        == (64, 128, 256, 512, 512)
    assert backbone_channels("alex") == ALEXNET_CHNS \
        == (64, 192, 384, 256, 256)
    assert backbone_channels("squeeze") == SQUEEZE_CHNS \
        == (64, 128, 256, 384, 384, 512, 512)
    assert backbone_channels("resnet") == backbone_channels("resnet18") \
        == RESNET18_CHNS == (64, 64, 128, 256, 512)
    for net in ("vgg", "alex", "squeeze", "resnet18"):
        assert tuple(int(w.numel()) for w in tl.LPIPS(net).lins) \
            == backbone_channels(net)
    for bad in ("vgg19", "dense"):
        with pytest.raises(ValueError, match="unknown LPIPS backbone"):
            backbone_channels(bad)
        with pytest.raises(ValueError, match="unknown LPIPS backbone"):
            tl.LPIPS(bad)


@pytest.mark.parametrize("net,shapes", [
    ("alex", [(15, 15, 64), (7, 7, 192), (3, 3, 384), (3, 3, 256),
              (3, 3, 256)]),
    ("squeeze", [(31, 31, 64), (15, 15, 128), (7, 7, 256), (3, 3, 384),
                 (3, 3, 384), (3, 3, 512), (3, 3, 512)]),
    ("resnet", [(32, 32, 64), (16, 16, 64), (8, 8, 128), (4, 4, 256),
                (2, 2, 512)]),
])
def test_tap_shapes_at_64px(net, shapes):
    """The per-image tap sizes at 64 px, with K = taps + the 12,288-wide
    pixel part; the int8 engine's per-part int32 dot bound stays under
    2^31 (squeeze's first part is the widest: 61,504 columns)."""
    assert tap_shapes(net, (64, 64, 3)) == shapes
    k_taps = {"alex": 31872, "squeeze": 118976, "resnet": 96256}[net]
    model = tl.init_lpips_params(0, net)
    assert tl.embed_dim(model, 64) == k_taps == sum(
        h * w * c for h, w, c in shapes)
    assert k_taps + 3 * 64 * 64 == k_taps + 12288
    assert len(model.lins) == len(shapes)
    bounds = lpips_part_int_dot_bounds(model, (64, 64, 3))
    assert max(bounds) < 2.0 ** 31
    if net == "squeeze":
        assert shapes[0][0] * shapes[0][1] * shapes[0][2] == 61504
        assert 127.0 ** 2 * 61504 < 2.0 ** 31


# ---------------------------------------------------------------------------
# towers and distances against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res", [64, 34])
@pytest.mark.parametrize("net", NETS)
def test_taps_match_jax(shared, net, res):
    """At 34 px squeeze's first ceil-mode pool meets a 16-wide map, so its
    last window is partial (torch ``ceil_mode`` against the JAX -inf
    right pad)."""
    p, model = shared[net]
    x = _images(res, res=res)
    with torch.no_grad():
        got = model.features(torch.from_numpy(x))
    want = j_features(p, jnp.asarray(x))
    assert [tuple(g.shape[1:]) for g in got] == tap_shapes(net,
                                                           (res, res, 3))
    assert len(got) == len(want) == len(backbone_channels(net))
    if net == "squeeze" and res == 34:
        assert (got[0].shape[1] - 3) % 2 == 1  # a partial window
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        w = np.asarray(w)
        # atol in units of the tap's scale where it exceeds 1: alex's raw
        # taps reach ~2.8 at 64 px (VGG16's stay under 1.5), and a sum of
        # 1,600 float32 products differs between the two conv libraries by
        # up to ~1.4e-6 of that scale
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("fn", ["lpips_pair", "pnet_pair"])
@pytest.mark.parametrize("net", NETS)
def test_pair_distances_match_jax(shared, net, fn):
    p, model = shared[net]
    x, y = _images(1, n=1), _images(2, n=3)  # broadcast on the batch
    with torch.no_grad():
        got = getattr(tl, fn)(model, torch.from_numpy(x),
                              torch.from_numpy(y)).numpy()
    want = np.asarray(getattr(jl, fn)(p, jnp.asarray(x), jnp.asarray(y)))
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        same = getattr(tl, fn)(model, torch.from_numpy(y),
                               torch.from_numpy(y)).numpy()
    assert np.abs(same).max() < 1e-5


def test_squeeze_has_seven_lins_and_resnet_feeds_pnet():
    """Mirrors the JAX package's seven-lin squeeze and resnet 'net' cases:
    distances non-negative, zero on identical inputs."""
    sq = tl.init_lpips_params(0, "squeeze")
    assert len(sq.lins) == 7
    assert [int(w.numel()) for w in sq.lins] == list(SQUEEZE_CHNS)
    x = torch.from_numpy(_images(4))
    y = torch.from_numpy(_images(5))
    with torch.no_grad():
        d = tl.lpips_pair(sq, x, y).numpy()
        assert d.shape == (2,) and (d >= 0).all()
        assert tl.lpips_pair(sq, x, x).numpy().max() < 1e-10
        rn = tl.init_lpips_params(0, "resnet18")
        d = tl.pnet_pair(rn, x, y).numpy()
        assert d.shape == (2,) and (d > 0).all()
        assert abs(float(tl.pnet_pair(rn, x, x)[0])) < 1e-5


def test_perceptual_loss_facade(shared, tmp_path):
    """``normalize=True`` maps [0, 1] inputs to [-1, 1]; the facade loads
    an npz or builds the default params, as the JAX facade does."""
    p, _ = shared["alex"]
    path = str(tmp_path / "alex.npz")
    jl.save_lpips_params(path, p)
    a01 = (_images(6) + 1) / 2
    b01 = (_images(7) + 1) / 2
    got = tl.PerceptualLoss(weights=path, device="cpu")(
        torch.from_numpy(a01), torch.from_numpy(b01), normalize=True)
    want = jl.PerceptualLoss(weights=path)(jnp.asarray(a01),
                                           jnp.asarray(b01), normalize=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    assert tl.PerceptualLoss(net="squeeze",
                             device="cpu").model.net == "squeeze"


# ---------------------------------------------------------------------------
# weights: npz schema and the converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", ["alex", "squeeze", "resnet18"])
def test_npz_round_trip_both_ways(tmp_path, net):
    """JAX npz -> port -> npz -> JAX: every array bit-identical."""
    p = jl.init_lpips_params(seed=2, net=net)
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jl.save_lpips_params(a, p)
    model = tl.load_lpips_params(a)
    assert model.net == net and len(model.tower.convs) == len(p["convs"])
    tl.save_lpips_params(b, model)
    back = jl.load_lpips_params(b)
    assert back["net"] == net
    for c0, c1 in zip(p["convs"], back["convs"]):
        np.testing.assert_array_equal(np.asarray(c1["kernel"]),
                                      np.asarray(c0["kernel"]))
        np.testing.assert_array_equal(np.asarray(c1["bias"]),
                                      np.asarray(c0["bias"]))
    for l0, l1 in zip(p["lins"], back["lins"]):
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l0))
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)


def _alex_state_dict(rng):
    sd = {}
    c = 3
    for idx, (out, k) in zip(tconv.ALEXNET_FEATURE_IDX,
                             ((64, 11), (192, 5), (384, 3), (256, 3),
                              (256, 3))):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.standard_normal((out, c, k, k)) * 0.1).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            (rng.standard_normal(out) * 0.1).astype(np.float32))
        c = out
    return sd


@pytest.mark.parametrize("net", ["alex", "squeeze", "resnet18"])
def test_converter_matches_jax(rng, net):
    sd = {"alex": _alex_state_dict, "squeeze": _squeeze_state_dict,
          "resnet18": _resnet_state_dict}[net](rng)
    got = tconv.convert_backbone_state_dict(sd, net)
    want = jconv.convert_backbone_state_dict(sd, net)
    shapes = [tuple(c.weight.shape[2:]) + (c.weight.shape[1],
                                           c.weight.shape[0])
              for c in Tower(net).convs]
    assert [g["kernel"].shape for g in got] == shapes
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["kernel"].dtype == g["bias"].dtype == np.float32
        if net != "resnet18":
            np.testing.assert_array_equal(g["kernel"], np.asarray(w["kernel"]))
            np.testing.assert_array_equal(g["bias"], np.asarray(w["bias"]))
        else:  # the float32 fold is within an ulp or two of float64's
            np.testing.assert_allclose(g["kernel"], np.asarray(w["kernel"]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(g["bias"], np.asarray(w["bias"]),
                                       rtol=1e-6, atol=1e-7)
    if net == "resnet18":  # the fold is float64, rounded once
        def f64(k):
            return sd[k].double().numpy()
        a = f64("bn1.weight") / np.sqrt(f64("bn1.running_var") + 1e-5)
        np.testing.assert_array_equal(
            got[0]["kernel"],
            (f64("conv1.weight") * a[:, None, None, None])
            .astype(np.float32).transpose(2, 3, 1, 0))
        np.testing.assert_array_equal(
            got[0]["bias"],
            (f64("bn1.bias") - f64("bn1.running_mean") * a)
            .astype(np.float32))


@pytest.mark.parametrize("net", ["squeeze", "resnet18"])
def test_converted_tower_matches_torch_oracle(rng, net):
    """The port's tower on converted weights against the torchvision
    forward rebuilt from functional ops (the JAX package's oracles); the
    resnet case runs the BatchNorms unfolded, in eval mode."""
    if net == "squeeze":
        sd, oracle = _squeeze_state_dict(rng), _torch_squeeze_taps
    else:
        sd, oracle = _resnet_state_dict(rng), _torch_resnet_taps
    model = lpips_from_jax_params({
        "net": net, "convs": tconv.convert_backbone_state_dict(sd, net),
        "lins": [np.ones(c, np.float32) for c in backbone_channels(net)]})
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.tower(torch.from_numpy(x))
        ref = oracle(sd, torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        rn = r.numpy().transpose(0, 2, 3, 1)
        # unnormalised random-weight activations grow to O(100s): the
        # JAX test's bar, relative to the layer's scale
        np.testing.assert_allclose(g.numpy(), rn, rtol=1e-3,
                                   atol=1e-4 * max(1.0, np.abs(rn).max()))


def test_convert_cli_writes_the_shared_npz(rng, tmp_path):
    """``main`` reads .pth state dicts with torch and writes the npz both
    packages load."""
    sd = _squeeze_state_dict(rng)
    backbone = str(tmp_path / "squeeze.pth")
    torch.save(sd, backbone)
    lin = str(tmp_path / "lin.pth")
    lins = [rng.uniform(0, 0.1, c).astype(np.float32) for c in SQUEEZE_CHNS]
    torch.save({f"lin{i}.model.1.weight":
                torch.from_numpy(w.reshape(1, -1, 1, 1))
                for i, w in enumerate(lins)}, lin)
    out = str(tmp_path / "out.npz")
    tconv.main(["--net", "squeeze", "--backbone", backbone, "--lin", lin,
                "--out", out])
    p = jl.load_lpips_params(out)
    assert p["net"] == "squeeze"
    for g, w in zip(p["convs"], jconv.convert_backbone_state_dict(
            sd, "squeeze")):
        np.testing.assert_array_equal(np.asarray(g["kernel"]),
                                      np.asarray(w["kernel"]))
    for g, w in zip(p["lins"], lins):
        np.testing.assert_array_equal(np.asarray(g), w)
    with pytest.raises(ValueError, match="no lin"):
        tconv.convert_lin_state_dict({})


# ---------------------------------------------------------------------------
# K2 on the new towers' taps
# ---------------------------------------------------------------------------

MODES = {  # (embed dtype, out dtype, int8) in JAX and in the port
    "f32": ((jnp.float32, jnp.float32, False),
            (torch.float32, torch.float32)),
    "bf16": ((jnp.bfloat16, jnp.bfloat16, False),
             (torch.bfloat16, torch.bfloat16)),
    "int8": ((jnp.bfloat16, jnp.int8, True),
             (torch.bfloat16, torch.int8)),
}


def _jax_part(fl, sc, je, jo, qb):
    """The JAX featuriser's part for one tap: the Pallas kernel in
    interpret mode, or the XLA math ``lpips_fast_parts_norms`` runs for a
    tap outside the kernel's envelope; unpacked to (N, P, C)."""
    n, p, c = fl.shape
    res = j_tap(jnp.asarray(fl), sc, embed_dtype=je, out_dtype=jo,
                quant_bound=qb, interpret=True)
    if res is None:
        phi = jl.normalize_tensor(jnp.asarray(fl)) * jnp.asarray(sc)
        b = _pack_lanes(phi.astype(je).reshape(n, p, c), mode="halves")
        out = j_quantize_int8(b, qb) if qb is not None else b.astype(jo)
    else:
        out = res[0]
    return np.asarray(_unpack_lanes(out, c, mode="halves")), res is None


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("net", ["alex", "squeeze"])
def test_k2_plain_parts_on_tower_taps_match_jax(shared, net, mode):
    """K2's plain version (what the wrapper runs for CPU tensors) on every
    64-px tap of the tower, bit for bit against the JAX package."""
    _, model = shared[net]
    (je, jo, quant), (te, to) = MODES[mode]
    with torch.no_grad():
        taps = model.features(torch.from_numpy(_images(8)))
    bounds = tl.lpips_part_bounds(model, (64, 64, 3))
    outside = 0
    for i, (fl, w) in enumerate(zip(taps, model.lins)):
        n, h, wd, c = fl.shape
        sc = _tap_scale(w, 0.2, h * wd).numpy()
        qb = bounds[i] if quant else None
        part, rn = tap_epilogue(fl, sc, embed_dtype=te, out_dtype=to,
                                quant_bound=qb)
        want, was_outside = _jax_part(fl.reshape(n, h * wd, c).numpy(), sc,
                                      je, jo, qb)
        outside += was_outside
        got = part.numpy() if to != torch.bfloat16 \
            else part.view(torch.int16).numpy()
        if to == torch.bfloat16:
            want = want.view(np.int16)
        np.testing.assert_array_equal(got, want, err_msg=f"tap {i} {c}")
        assert rn.dtype == torch.float32 and tuple(rn.shape) == (n,)
    # alex: (225, 64) and (49, 192) fall outside the TPU kernel; squeeze:
    # (961, 64)
    assert outside == {"alex": 2, "squeeze": 1}[net]


# ---------------------------------------------------------------------------
# the fbb attack on the alex tower
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def alex_sets(tmp_path_factory):
    """npz image sets at 32 px (members are noisy copies of synthetic
    images) and the alex LPIPS npz both packages load."""
    d = tmp_path_factory.mktemp("alex_sets")
    rng = np.random.default_rng(11)
    syn = rng.integers(0, 256, (12, 32, 32, 3), dtype=np.uint8)
    pos = np.clip(syn[:6].astype(np.int16)
                  + rng.integers(-6, 7, (6, 32, 32, 3)), 0, 255
                  ).astype(np.uint8)
    neg = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    paths = {}
    for name, arr in (("syn", syn), ("pos", pos), ("neg", neg)):
        paths[name] = str(d / f"{name}.npz")
        np.savez(paths[name], images=arr)
    paths["lpips"] = str(d / "lpips_alex.npz")
    jl.save_lpips_params(paths["lpips"], jl.init_lpips_params(0, "alex"))
    return paths


@pytest.mark.parametrize("engine", ["gemm", "taps", "taps-int8"])
def test_fbb_attack_on_alex_matches_jax(alex_sets, tmp_path, monkeypatch,
                                        engine):
    monkeypatch.chdir(tmp_path)
    kw = dict(syn_data_path=alex_sets["syn"], pos_data_dir=alex_sets["pos"],
              neg_data_dir=alex_sets["neg"], resolution=32,
              distance="l2-lpips", lpips_net="alex",
              lpips_weights=alex_sets["lpips"], engine=engine,
              query_block=4, syn_block=8, save_plots=False,
              decode_cache=False)
    rj = j_run_attack(JAttackConfig(exp_name="alex_jax", **kw))[0]
    rt = run_attack(AttackConfig(exp_name="alex_port", **kw),
                    device="cpu")[0]
    for key in ("pos_nn_idx", "neg_nn_idx"):
        np.testing.assert_array_equal(rt[key], rj[key])
    np.testing.assert_array_equal(rt["pos_nn_idx"], np.arange(6))
    for key in ("pos_loss", "neg_loss"):
        got = np.load(os.path.join(rt["save_dir"], f"{key}.npy"))
        want = np.load(os.path.join(rj["save_dir"], f"{key}.npy"))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    auc_t = evaluate(EvalConfig(result_load_dir=rt["save_dir"]))["auc"]
    auc_j = j_evaluate(JEvalConfig(result_load_dir=rj["save_dir"]))["auc"]
    np.testing.assert_allclose(auc_t, auc_j, atol=1e-6)
    assert auc_t > 0.9
