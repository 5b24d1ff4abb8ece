"""The port's fbb driver end to end on the CPU against the JAX package's
(mirrors ``tests/test_pipeline_e2e.py:129``): the same fixture PNG dirs and
one shared LPIPS npz (``lpips_weights``) through
``ganleaks_tpu.attack.fbb.run_attack`` and
``ganleaks_tpu_torch.attack.fbb.run_attack(device='cpu')``.

Checks: identical ``pos_nn_idx``/``neg_nn_idx``; losses within rtol 1e-5
plus atol 1e-6 — the absolute part because a loss is rq + rs - 2 q.s in
float32 with O(1) norms, so near-copy losses (~0.01) carry ~5e-7 of
rounding on either side (the JAX package's own gemm and pallas engines
differ by that much here); AUROC within 1e-6; the same artifact files, and
byte-identical closest-pair PNGs.
"""

import os
import sys

import numpy as np
import PIL.Image
import pytest

from ganleaks_tpu.attack.eval_roc import evaluate as j_evaluate
from ganleaks_tpu.attack.fbb import run_attack as j_run_attack
from ganleaks_tpu.cli.common import parse_config as j_parse_config
from ganleaks_tpu.config import AttackConfig as JAttackConfig
from ganleaks_tpu.config import EvalConfig as JEvalConfig
from ganleaks_tpu.config import ScoresConfig as JScoresConfig
from ganleaks_tpu.io.images import save_png
from ganleaks_tpu.ops.lpips import default_lpips_params, save_lpips_params
from ganleaks_tpu_torch.attack.eval_roc import evaluate
from ganleaks_tpu_torch.attack.fbb import (attack_arrays,
                                           resolve_auto_engine, run_attack)
from ganleaks_tpu_torch.cli import eval_roc as cli_eval_roc
from ganleaks_tpu_torch.cli.common import parse_config
from ganleaks_tpu_torch.config import AttackConfig, EvalConfig, ScoresConfig
from ganleaks_tpu_torch.io.native import decode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_set(d, name, arr):
    os.makedirs(d)
    for i, img in enumerate(np.clip(arr, -1, 1)):
        save_png((img + 1) / 2, str(d / f"{name}_{i:03d}.png"))


@pytest.fixture
def fixture_dirs(tmp_path, rng):
    """The planted-signal sets of ``tests/test_pipeline_e2e.py``: members
    are noisy copies of some synthetic images."""
    base = rng.uniform(-0.8, 0.8, (12, 32, 32, 3)).astype(np.float32)
    syn = base + rng.normal(0, 0.05, base.shape).astype(np.float32)
    pos = base[:6] + rng.normal(0, 0.1, (6, 32, 32, 3)).astype(np.float32)
    neg = rng.uniform(-0.8, 0.8, (6, 32, 32, 3)).astype(np.float32)
    dirs = []
    for name, arr in (("syn", syn), ("pos", pos), ("neg", neg)):
        _write_set(tmp_path / name, name, arr)
        dirs.append(str(tmp_path / name))
    return tuple(dirs)


@pytest.fixture
def lpips_npz(tmp_path):
    path = str(tmp_path / "lpips_vgg.npz")
    save_lpips_params(path, default_lpips_params())
    return path


def _assert_runs_agree(rj, rt, lpips: bool):
    for key in ("pos_nn_idx", "neg_nn_idx"):
        np.testing.assert_array_equal(
            np.load(os.path.join(rt["save_dir"], f"{key}.npy")),
            np.load(os.path.join(rj["save_dir"], f"{key}.npy")))
    for key in ("pos_loss", "neg_loss"):
        got = np.load(os.path.join(rt["save_dir"], f"{key}.npy"))
        want = np.load(os.path.join(rj["save_dir"], f"{key}.npy"))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 if lpips else 1e-7)
    for key in ("pos_idx", "neg_idx"):
        np.testing.assert_array_equal(
            np.load(os.path.join(rt["save_dir"], f"{key}.npy")),
            np.load(os.path.join(rj["save_dir"], f"{key}.npy")))
    assert sorted(os.listdir(rt["save_dir"])) \
        == sorted(os.listdir(rj["save_dir"]))
    for f in os.listdir(rj["save_dir"]):
        if f.endswith(".png"):  # the port's encoder: same pixels
            np.testing.assert_array_equal(
                decode_png(os.path.join(rt["save_dir"], f)),
                np.asarray(PIL.Image.open(os.path.join(rj["save_dir"], f))),
                err_msg=f)
    # the port's AttackConfig adds one field, the planner's switch
    with open(os.path.join(rj["save_dir"], "params.txt")) as a, \
            open(os.path.join(rt["save_dir"], "params.txt")) as b:
        got = b.read()
        assert "\nauto_plan:True\n" in got
        assert a.read().replace("e2e_jax", "e2e_port") \
            == got.replace("\nauto_plan:True\n", "\n")
    auc_t = evaluate(EvalConfig(result_load_dir=rt["save_dir"]))["auc"]
    auc_j = j_evaluate(JEvalConfig(result_load_dir=rj["save_dir"]))["auc"]
    np.testing.assert_allclose(auc_t, auc_j, atol=1e-6)
    return auc_t


@pytest.mark.parametrize("distance,engine,extra", [
    ("l2-lpips", "pallas", {}),
    ("l2-lpips", "gemm", {}),
    # the strict-parity pixel path of test_full_pipeline, with plots
    ("l2", "exact", {"BATCH_SIZE": 4, "drop_remainder": True,
                     "save_plots": True}),
])
def test_run_attack_matches_jax(fixture_dirs, lpips_npz, tmp_path,
                                monkeypatch, distance, engine, extra):
    syn_dir, pos_dir, neg_dir = fixture_dirs
    monkeypatch.chdir(tmp_path)
    kw = dict(syn_data_path=syn_dir, pos_data_dir=pos_dir,
              neg_data_dir=neg_dir, resolution=32, distance=distance,
              engine=engine, query_block=4, syn_block=8, save_plots=False,
              lpips_weights=lpips_npz, decode_cache=False)
    kw.update(extra)
    rj = j_run_attack(JAttackConfig(exp_name="e2e_jax", **kw))[0]
    rt = run_attack(AttackConfig(exp_name="e2e_port", **kw),
                    device="cpu")[0]
    auc = _assert_runs_agree(rj, rt, distance == "l2-lpips")
    assert auc > 0.9  # members are plainly closer
    assert rt["query_pairs_per_sec"] > 0
    assert rt["featurize_s"] >= 0 and rt["fold_s"] >= 0


def test_hyperparameter_sweep_layout(fixture_dirs, tmp_path, monkeypatch):
    """One attack per synthetic subdir, saved under
    ``<save_root>/<exp>__<root name>/<subdir>`` as the JAX driver does."""
    syn_dir, pos_dir, neg_dir = fixture_dirs
    root = tmp_path / "sweep" / "runs"
    for sub, sl in (("a", slice(0, 8)), ("b", slice(4, 12))):
        os.makedirs(root / sub)
        for f in sorted(os.listdir(syn_dir))[sl]:
            os.link(os.path.join(syn_dir, f), root / sub / f)
    os.makedirs(root / ".hidden")
    monkeypatch.chdir(tmp_path)
    kw = dict(syn_data_path=str(root), pos_data_dir=pos_dir,
              neg_data_dir=neg_dir, resolution=32, distance="l2",
              engine="gemm", hyperparameter_search=True, save_plots=False,
              decode_cache=False)
    rj = j_run_attack(JAttackConfig(exp_name="sw", **kw))
    rt = run_attack(AttackConfig(exp_name="sw", save_root="port", **kw),
                    device="cpu")
    assert len(rt) == len(rj) == 2
    for a, b in zip(rj, rt):
        assert os.path.relpath(b["save_dir"], "port") \
            == os.path.relpath(a["save_dir"], "fbb_attack")
        np.testing.assert_array_equal(b["pos_nn_idx"], a["pos_nn_idx"])
        np.testing.assert_allclose(b["neg_loss"], a["neg_loss"],
                                   rtol=1e-5, atol=1e-7)


def test_attack_arrays_refuses_unported_layouts():
    """Multi-GPU layouts are refused; two_pass and the taps engines are
    ported now and run (``tests/test_torch_two_pass.py`` holds them
    against the JAX package)."""
    imgs = np.zeros((2, 8, 8, 3), np.uint8)
    for over in ({"two_pass": True}, {"engine": "taps"},
                 {"engine": "taps-int8"}):
        out = attack_arrays(AttackConfig(distance="l2", **over), imgs, imgs,
                            imgs, device="cpu")
        assert out["pos_loss"].shape == (2,)
    for over, item in (({"n_chips": 4}, "M12"),
                       ({"multihost": True}, "M12")):
        with pytest.raises(NotImplementedError, match=item):
            attack_arrays(AttackConfig(distance="l2", **over), imgs, imgs,
                          imgs, device="cpu")
    with pytest.raises(ValueError, match="shard_layout"):
        attack_arrays(AttackConfig(distance="l2", shard_layout="x"), imgs,
                      imgs, imgs, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        attack_arrays(AttackConfig(distance="l2", dtype="float16"), imgs,
                      imgs, imgs, device="cpu")


def test_auto_engine_resolution():
    cfg = AttackConfig(engine="auto")
    assert resolve_auto_engine(cfg, "cpu").engine == "gemm"
    # CUDA: the JAX package's accelerator recipe (no device is touched)
    assert resolve_auto_engine(cfg, "cuda").engine == "taps-int8"
    assert resolve_auto_engine(AttackConfig(engine="exact"),
                               "cuda").engine == "exact"


def test_cli_config_matches_jax():
    """The same YAML and overrides parse to the same fields in both
    packages, so existing configs run unchanged."""
    argv = ["--local_config",
            os.path.join(REPO, "configs", "config_attack_fbb.yaml"),
            "engine=pallas", "query_cache_gb=4", "save_plots=false"]
    got, device = parse_config(AttackConfig, argv)
    assert device == "cuda"  # never chosen by what the machine has
    assert parse_config(AttackConfig, ["--device", "cpu"] + argv)[1] == "cpu"
    want = j_parse_config(JAttackConfig, argv)
    fields = dict(vars(got))
    assert fields.pop("auto_plan") is True  # the port's planner switch
    assert fields == vars(want)
    assert got.engine == "pallas" and got.distance == "l2-lpips"
    with pytest.raises(KeyError):
        parse_config(AttackConfig, ["no_such_key=1"])


@pytest.mark.parametrize("cls,jcls,argv", [
    (AttackConfig, JAttackConfig,
     ["save_plots=no", "syn_data_path=null", "host_stream=false",
      "decode_cache=auto", "query_cache_gb=1e-4", "query_block=64",
      "lpips_net=squeeze"]),
    (AttackConfig, JAttackConfig,
     ["save_plots=TRUE", "syn_data_path=~", "host_stream=On",
      "decode_cache=true", "query_cache_gb=2", "exp_name=run7"]),
    (ScoresConfig, JScoresConfig,
     ["limit=5", "weights=null", "net=alex", "batch_size=3",
      "out_json=s.json"]),
    (ScoresConfig, JScoresConfig, ["limit=~", "mode=jnd", "model=net"]),
])
def test_cli_overrides_parse_without_pyyaml(monkeypatch, cls, jcls, argv):
    """``key=value`` overrides are parsed by their field's type alone: the
    same fields with PyYAML importable or not, and the JAX package's (the
    port's AttackConfig adds ``auto_plan``, the planner's switch)."""
    want = vars(j_parse_config(jcls, argv))

    def port_fields():
        got = vars(parse_config(cls, argv)[0])
        if cls is AttackConfig:
            assert got.pop("auto_plan") is True
        return got

    assert port_fields() == want
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises
    assert port_fields() == want


def test_eval_cli(tmp_path, capsys):
    run = tmp_path / "run"
    os.makedirs(run)
    np.save(run / "pos_loss.npy", np.array([[0.1], [0.2], [0.3]]))
    np.save(run / "neg_loss.npy", np.array([[0.4], [0.5], [0.25]]))
    cli_eval_roc.main(["--device", "cpu", f"result_load_dir={run}"])
    assert "The AUC ROC value of fbb attack is: 0.889" \
        in capsys.readouterr().out
    assert os.path.exists(run / "roc.png")


@pytest.mark.parametrize("key,layout,kind,res", [
    ("fake", "NCHW", "float", 16),      # dcgan/pggan dump, [0, 1] floats
    ("img_r01", "NHWC", "float", 8),    # vaegan dump, resized 16 -> 8
    ("images", "NHWC", "uint8", 16),
    ("other", "NHWC", "gray", 16),      # single unknown 4-D key, 1 channel
])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_ingest_matches_jax(rng, tmp_path, key, layout, kind, res, dtype):
    """npz and PNG readers of the port give the JAX package's arrays bit
    for bit, and the format resolver decides alike."""
    from ganleaks_tpu.io.images import load_image_dir as j_load_dir
    from ganleaks_tpu.io.npz import load_npz_images as j_load_npz
    from ganleaks_tpu.io.npz import resolve_input_format as j_resolve
    from ganleaks_tpu_torch.io.images import load_image_dir
    from ganleaks_tpu_torch.io.npz import (load_npz_images,
                                           resolve_input_format)

    c = 1 if kind == "gray" else 3
    if kind == "uint8":
        arr = rng.integers(0, 256, (5, 16, 16, c), dtype=np.uint8)
    else:
        arr = rng.random((5, 16, 16, c)).astype(np.float32)
    if layout == "NCHW":
        arr = arr.transpose(0, 3, 1, 2)
    d = tmp_path / "set"
    os.makedirs(d)
    np.savez(d / "a.npz", **{key: arr[:3]})
    np.savez(d / "b.npz", **{key: arr[3:]})
    got = load_npz_images(str(d), res, limit=4, dtype=dtype)
    want = j_load_npz(str(d), res, limit=4, dtype=dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert resolve_input_format(str(d)) == j_resolve(str(d)) == "npz"

    png = tmp_path / "png"
    _write_set(png, "x", rng.uniform(-1, 1, (3, 16, 16, 3)))
    np.testing.assert_array_equal(load_image_dir(str(png), res, dtype=dtype),
                                  j_load_dir(str(png), res, dtype=dtype))
    assert resolve_input_format(str(png)) == j_resolve(str(png)) == "png"
