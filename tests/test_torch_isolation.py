"""The PyTorch port stands alone: no module of ``ganleaks_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, optional libraries load
lazily, the main path runs with torch, numpy and the standard library
alone, and entry points refuse to run without a GPU unless asked for the
CPU."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ganleaks_tpu_torch")
LAZY = ("yaml", "PIL", "matplotlib", "wandb", "pandas", "scipy", "msgpack")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ganleaks_tpu", "sklearn")


def _port_sources() -> list[str]:
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _s, files in os.walk(PKG):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imports(tree: ast.AST):
    """(top-level module name, at module level?) for every import."""
    out = []

    def visit(node, depth):
        for child in ast.iter_child_nodes(node):
            inner = depth + isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], depth == 0)
                           for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module:
                out.append((child.module.split(".")[0], depth == 0))
            visit(child, inner)

    visit(tree, 0)
    return out


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_and_lazy_optionals(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for mod, top in _imports(tree):
        assert mod not in FORBIDDEN, f"{path} imports {mod}"
        assert not (top and mod in LAZY), \
            f"{path} imports {mod} at module level"


def _run_isolated(code: str) -> subprocess.CompletedProcess:
    """Run ``code`` in a fresh interpreter where importing JAX, the JAX
    package or an optional library raises."""
    blocker = textwrap.dedent(f"""
        import importlib.abc
        import importlib.machinery
        import sys
        sys.path.insert(0, {REPO!r})
        BLOCKED = {FORBIDDEN + LAZY!r}

        class _Refuse(importlib.abc.Loader):
            def create_module(self, spec):
                raise ImportError(f"blocked import of {{spec.name}}")

            def exec_module(self, module):
                pass

        class _Block:
            # a spec whose loading raises: importing a blocked module
            # fails, while a probe that only asks for the spec (torch's
            # optimisers look for pandas this way) finds no file to read
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    return importlib.machinery.ModuleSpec(name, _Refuse())
                return None

        sys.meta_path.insert(0, _Block())
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", blocker + code],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=REPO)


def test_import_leaves_jax_out():
    code = textwrap.dedent("""
        import pkgutil, importlib
        import ganleaks_tpu_torch
        for m in pkgutil.walk_packages(ganleaks_tpu_torch.__path__,
                                       "ganleaks_tpu_torch."):
            importlib.import_module(m.name)
        bad = [m for m in sys.modules
               if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
    """)
    res = _run_isolated(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_main_path_without_optional_libraries(tmp_path):
    """npz ingest -> l2-lpips attack (fused engine, CPU) -> evaluate, with
    JAX, PyYAML, Pillow, matplotlib, sklearn and scipy all unimportable."""
    rng = np.random.default_rng(0)
    for name, n in (("pos", 4), ("neg", 4), ("syn", 6)):
        np.savez(tmp_path / f"{name}.npz",
                 images=rng.integers(0, 256, (n, 32, 32, 3), np.uint8))
    code = textwrap.dedent(f"""
        import os
        import numpy as np
        from ganleaks_tpu_torch.attack.eval_roc import evaluate
        from ganleaks_tpu_torch.attack.fbb import run_attack
        from ganleaks_tpu_torch.config import AttackConfig, EvalConfig
        d = {str(tmp_path)!r}
        os.chdir(d)
        cfg = AttackConfig(syn_data_path=d + "/syn.npz",
                           pos_data_dir=d + "/pos.npz",
                           neg_data_dir=d + "/neg.npz", resolution=32,
                           engine="pallas", save_plots=False)
        out = run_attack(cfg, device="cpu")[0]
        res = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
        assert np.isfinite(out["pos_loss"]).all()
        assert 0.0 <= res["auc"] <= 1.0
        print("ok")
    """)
    res = _run_isolated(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_taps_and_two_pass_paths_without_optional_libraries(tmp_path):
    """The tap-structured engines and the certified two-pass mode (tap
    epilogue, top-k, int8 folds) run with JAX, PyYAML, Pillow,
    matplotlib, sklearn and scipy all unimportable."""
    code = textwrap.dedent("""
        import numpy as np
        from ganleaks_tpu_torch.attack.fbb import attack_arrays
        from ganleaks_tpu_torch.config import AttackConfig
        rng = np.random.default_rng(0)
        syn = rng.integers(0, 256, (6, 32, 32, 3), np.uint8)
        pos = syn[:2].copy()
        neg = rng.integers(0, 256, (2, 32, 32, 3), np.uint8)
        for engine, two_pass in (("taps", False), ("taps-int8", True)):
            cfg = AttackConfig(engine=engine, two_pass=two_pass,
                               resolution=32, query_block=2, syn_block=4,
                               save_plots=False)
            out = attack_arrays(cfg, syn, pos, neg, device="cpu")
            assert out["pos_nn_idx"].tolist() == [0, 1], out
        print("ok")
    """)
    res = _run_isolated(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_fid_reconstruction_tabular_without_optional_libraries(tmp_path):
    """FID (the eigh square root), the reconstruction attack
    (distance='l2', npz weights and npz queries) and the tabular attack
    (.npy rows, the fused engine) run with JAX, PyYAML, Pillow,
    matplotlib, sklearn, scipy, pandas and msgpack all unimportable."""
    code = textwrap.dedent(f"""
        import os
        import numpy as np
        import torch
        from ganleaks_tpu_torch.attack.eval_roc import evaluate
        from ganleaks_tpu_torch.attack.reconstruction import (
            run_reconstruction_attack)
        from ganleaks_tpu_torch.attack.tabular import run_tabular_attack
        from ganleaks_tpu_torch.config import (EvalConfig,
                                               ReconstructionConfig,
                                               TabularAttackConfig)
        from ganleaks_tpu_torch.models.vaegan import Encoder, Generator
        from ganleaks_tpu_torch.ops.fid import (fid_from_image_sets,
                                                init_inception_params)
        from ganleaks_tpu_torch.utils.checkpoint import save_params_npz
        from ganleaks_tpu_torch.weights import dump_jax_tree
        d = {str(tmp_path)!r}
        os.chdir(d)
        torch.set_num_threads(1)  # the suite runs in several processes
        rng = np.random.default_rng(0)
        a = rng.integers(0, 256, (4, 32, 32, 3), np.uint8)
        b = rng.integers(0, 256, (4, 32, 32, 3), np.uint8)
        val = fid_from_image_sets(init_inception_params(0), a, b,
                                  batch_size=2, method="eigh", device="cpu")
        assert np.isfinite(val), val

        for name, model in (("netE", Encoder(16, 8)),
                            ("netG", Generator(16, 8))):
            save_params_npz(f"{{d}}/{{name}}.npz", dump_jax_tree(model))
        for name in ("pos", "neg"):
            np.savez(f"{{d}}/{{name}}.npz",
                     images=rng.integers(0, 256, (3, 64, 64, 3), np.uint8))
        out = run_reconstruction_attack(ReconstructionConfig(
            pos_data_dir=d + "/pos.npz", neg_data_dir=d + "/neg.npz",
            netE=d + "/netE.npz", netG=d + "/netG.npz", z_dim=16, d=8,
            batch=2, save_plots=False), device="cpu")
        assert out["pos_loss"].shape == (3,)
        assert 0.0 <= evaluate(EvalConfig(
            result_load_dir=out["save_dir"]))["auc"] <= 1.0

        for name, n in (("syn", 30), ("pos", 5), ("neg", 5)):
            np.save(f"{{d}}/{{name}}.npy",
                    (rng.random((n, 17)) < 0.3).astype(np.float32))
        out = run_tabular_attack(TabularAttackConfig(
            syn_data_path=d + "/syn.npy", pos_data_path=d + "/pos.npy",
            neg_data_path=d + "/neg.npy", engine="pallas"), device="cpu")
        assert out["pos_nn_idx"].shape == (5,)
        print("ok")
    """)
    res = _run_isolated(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_lpips_towers_and_scores_without_optional_libraries(tmp_path):
    """The non-VGG towers through a taps attack and the scores CLI's npz
    route (its ``key=value`` overrides parsed without PyYAML) run with JAX,
    PyYAML, Pillow, matplotlib, sklearn, scipy, pandas and msgpack all
    unimportable."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    np.savez(tmp_path / "t.npz", ref=imgs, p0=imgs[::-1], p1=imgs,
             judge=np.array([0.0, 1.0, 0.5, 1.0]))
    code = textwrap.dedent(f"""
        import numpy as np
        import torch
        from ganleaks_tpu_torch.attack.fbb import attack_arrays
        from ganleaks_tpu_torch.cli.lpips_scores import main
        from ganleaks_tpu_torch.config import AttackConfig
        torch.set_num_threads(1)  # the suite runs in several processes
        rng = np.random.default_rng(0)
        syn = rng.integers(0, 256, (6, 32, 32, 3), np.uint8)
        pos = syn[:2].copy()
        neg = rng.integers(0, 256, (2, 32, 32, 3), np.uint8)
        for net in ("alex", "squeeze", "resnet"):
            cfg = AttackConfig(engine="taps-int8", lpips_net=net,
                               resolution=32, query_block=2, syn_block=4,
                               save_plots=False)
            out = attack_arrays(cfg, syn, pos, neg, device="cpu")
            assert out["pos_nn_idx"].tolist() == [0, 1], (net, out)
        d = {str(tmp_path)!r}
        res = main([f"data_dir={{d}}/t.npz", "mode=2afc", "model=net",
                    "net=squeeze", "batch_size=3", "limit=4"],
                   device="cpu")
        assert res["n"] == 4 and 0.0 <= res["score"] <= 1.0, res
        print("ok")
    """)
    res = _run_isolated(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_new_entry_points_refuse_without_gpu(monkeypatch, tmp_path):
    from ganleaks_tpu_torch.attack.reconstruction import (
        fbb_tabular, run_reconstruction_attack)
    from ganleaks_tpu_torch.attack.tabular import run_tabular_attack
    from ganleaks_tpu_torch.cli import fbb_tabular as cli_tabular
    from ganleaks_tpu_torch.cli import fid as cli_fid
    from ganleaks_tpu_torch.cli import lpips_scores as cli_scores
    from ganleaks_tpu_torch.cli import reconstruction as cli_recon
    from ganleaks_tpu_torch.config import (ReconstructionConfig,
                                           TabularAttackConfig)
    from ganleaks_tpu_torch.ops import fid
    from ganleaks_tpu_torch.ops.lpips.lpips import PerceptualLoss
    from ganleaks_tpu_torch.ops.lpips.scoring import make_pair_dist_fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    rows = np.zeros((3, 4), np.float32)
    np.savez(tmp_path / "s.npz", mu=np.zeros(2), sigma=np.eye(2))
    stats = str(tmp_path / "s.npz")
    imgs = np.zeros((2, 8, 8, 3), np.uint8)
    calls = [
        lambda: fid.get_activations(torch.nn.Identity(), imgs),
        lambda: fid.fid_from_image_sets(torch.nn.Identity(), imgs, imgs),
        lambda: fid.fid_from_paths(torch.nn.Identity(), stats, stats),
        lambda: fid.frechet_distance(np.zeros(2), np.eye(2), np.zeros(2),
                                     np.eye(2), method="eigh"),
        lambda: run_reconstruction_attack(ReconstructionConfig()),
        lambda: run_tabular_attack(TabularAttackConfig()),
        lambda: fbb_tabular(rows, rows, rows),
        lambda: cli_fid.main([stats, stats]),
        lambda: cli_recon.main([]),
        lambda: cli_tabular.main([]),
        lambda: cli_scores.main([f"data_dir={stats}"]),
        lambda: make_pair_dist_fn("net", net="alex"),
        lambda: PerceptualLoss(net="alex"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the host-only square root and distances need no device
    assert make_pair_dist_fn("l2")(imgs, imgs).shape == (2,)
    assert fid.frechet_distance(np.zeros(2), np.eye(2), np.zeros(2),
                                np.eye(2), method="scipy") == \
        pytest.approx(0.0, abs=1e-9)


def test_entry_points_refuse_without_gpu(monkeypatch, tmp_path):
    from ganleaks_tpu_torch.attack.fbb import attack_arrays, run_attack
    from ganleaks_tpu_torch.config import AttackConfig
    from ganleaks_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    cfg = AttackConfig(syn_data_path=str(tmp_path), distance="l2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_attack(cfg)
    imgs = np.zeros((2, 8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        attack_arrays(cfg, imgs, imgs, imgs)
    assert resolve_device("cpu").type == "cpu"
    out = attack_arrays(cfg, imgs, imgs, imgs, device="cpu")
    assert out["pos_loss"].shape == (2,)


def test_resolve_device_sets_f32_numerics(monkeypatch):
    from ganleaks_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_bench_and_planner_stand_alone():
    """``bench`` and ``ops/stream_plan`` import no JAX, no JAX package and
    no optional library: the bench's quick run on the CPU works with all
    of them unimportable (the static check above covers their module-level
    imports)."""
    code = textwrap.dedent("""
        import json
        import ganleaks_tpu_torch.ops.stream_plan
        from ganleaks_tpu_torch import bench
        bench.main(["--quick", "--n_q", "4", "--n_syn", "8"], device="cpu")
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
    """)
    res = _run_isolated(code)
    assert res.returncode == 0, res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}


def test_device_flags_refuse_without_gpu(monkeypatch, tmp_path):
    """``bench.main`` and every CLI's ``--device`` default (cuda) refuse
    without a GPU, whatever the machine has; ``--device cuda`` refuses
    too and ``--device cpu`` runs."""
    from ganleaks_tpu_torch import bench
    from ganleaks_tpu_torch.cli import eval_roc as cli_eval_roc
    from ganleaks_tpu_torch.cli import fbb as cli_fbb
    from ganleaks_tpu_torch.cli import fbb_tabular as cli_tabular
    from ganleaks_tpu_torch.cli import fid as cli_fid
    from ganleaks_tpu_torch.cli import lpips_scores as cli_scores
    from ganleaks_tpu_torch.cli import reconstruction as cli_recon

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    np.savez(tmp_path / "s.npz", mu=np.zeros(2), sigma=np.eye(2))
    stats = str(tmp_path / "s.npz")
    run = tmp_path / "run"
    run.mkdir()
    np.save(run / "pos_loss.npy", np.array([[0.1], [0.2]]))
    np.save(run / "neg_loss.npy", np.array([[0.4], [0.5]]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--quick"])
    for call in (
            lambda: cli_fbb.main([f"syn_data_path={tmp_path}"]),
            lambda: cli_eval_roc.main([f"result_load_dir={run}"]),
            lambda: cli_eval_roc.main(["--device", "cuda",
                                       f"result_load_dir={run}"]),
            lambda: cli_fid.main([stats, stats]),
            lambda: cli_recon.main([]),
            lambda: cli_tabular.main([]),
            lambda: cli_scores.main([f"data_dir={stats}"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cli_eval_roc.main(["--device", "cpu", f"result_load_dir={run}"])


def test_png_ingest_without_optional_libraries(tmp_path):
    """PNG directories written and read by the port's codec: the attack
    from PNG dirs with the decode cache and ``HostImageSet``, the
    closest-pair plots, the training-image reader and the synthetic
    artifact writer run with JAX, PyYAML, Pillow, matplotlib, sklearn,
    scipy, pandas and msgpack all unimportable."""
    code = textwrap.dedent(f"""
        import os
        import numpy as np
        import torch
        from ganleaks_tpu_torch.attack.fbb import run_attack
        from ganleaks_tpu_torch.config import AttackConfig
        from ganleaks_tpu_torch.io.artifacts import write_synthetic_artifacts
        from ganleaks_tpu_torch.io.data import load_train_images
        from ganleaks_tpu_torch.io.native import (decode_png,
                                                  save_png_batch_native)
        d = {str(tmp_path)!r}
        os.chdir(d)
        torch.set_num_threads(1)  # the suite runs in several processes
        rng = np.random.default_rng(0)
        sets = {{n: rng.integers(0, 256, (k, 32, 32, 3), np.uint8)
                 for n, k in (("pos", 3), ("neg", 3), ("syn", 8))}}
        sets["syn"][[2, 5, 7]] = sets["pos"]
        for n, arr in sets.items():
            os.makedirs(f"{{d}}/{{n}}")
            save_png_batch_native(arr, [f"{{d}}/{{n}}/{{i}}.png"
                                        for i in range(len(arr))])
        for host_stream in (False, True):
            cfg = AttackConfig(syn_data_path=d + "/syn",
                               pos_data_dir=d + "/pos",
                               neg_data_dir=d + "/neg", resolution=32,
                               distance="l2", host_stream=host_stream,
                               decode_cache="auto")
            out = run_attack(cfg, device="cpu")[0]
            assert out["pos_nn_idx"].tolist() == [2, 5, 7], out
        assert decode_png(out["save_dir"] + "/0pos.png").shape == (32, 64, 3)
        assert os.path.isdir(d + "/syn/.ganleaks_decoded")
        x = load_train_images(d + "/pos", 32)
        assert x.dtype == np.float32 and x.shape == (3, 32, 32, 3)
        dirs = write_synthetic_artifacts(d + "/art", "dcgan",
                                         (x + 1) / 2, np.zeros((3, 4)))
        assert len(os.listdir(dirs["png_images"])) == 3
        print("ok")
    """)
    res = _run_isolated(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_victim_entry_points_refuse_without_gpu(monkeypatch, tmp_path):
    """The trainers, the generators, their CLIs (whose ``--device``
    defaults to cuda) and ``bench --metric gen`` refuse without a GPU."""
    from ganleaks_tpu_torch import bench
    from ganleaks_tpu_torch.cli import train_dcgan as cli_dcgan
    from ganleaks_tpu_torch.cli import train_wgangp as cli_wgangp
    from ganleaks_tpu_torch.config import DCGANConfig, WGANGPConfig
    from ganleaks_tpu_torch.train import dcgan, wgangp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    imgs = np.zeros((4, 16, 16, 3), np.float32)
    cfg = DCGANConfig(image_size=16, nz=4, ngf=4, ndf=4)
    calls = [
        lambda: dcgan.train(cfg, images=imgs),
        lambda: dcgan.generate(cfg),
        lambda: wgangp.train(WGANGPConfig(), images=imgs),
        lambda: wgangp.generate(WGANGPConfig()),
        lambda: cli_dcgan.main([f"data_path={tmp_path}"]),
        lambda: cli_wgangp.main([f"data_path={tmp_path}"]),
        lambda: cli_dcgan.main(["--device", "cuda", "training=false"]),
        lambda: bench.main(["--metric", "gen", "--quick"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_victim_trainers_without_optional_libraries(tmp_path):
    """The VAE-GAN, medGAN and PGGAN trainers through their CLIs — PNG
    training sets, a CSV read without pandas, ``torch.optim`` (which probes
    for pandas), the checkpoints, ``netE`` / ``netG`` npz, the samples and
    ``synthetic.npy`` — run with JAX, PyYAML, Pillow, matplotlib, sklearn,
    scipy, pandas and msgpack all unimportable."""
    code = textwrap.dedent(f"""
        import os
        import numpy as np
        import torch
        from ganleaks_tpu_torch.cli import (train_medgan, train_pggan,
                                            train_vaegan)
        from ganleaks_tpu_torch.io.native import save_png_batch_native
        d = {str(tmp_path)!r}
        os.chdir(d)
        torch.set_num_threads(1)  # the suite runs in several processes
        rng = np.random.default_rng(0)
        os.makedirs("train")
        save_png_batch_native(rng.integers(0, 256, (4, 64, 64, 3), np.uint8),
                              [f"train/{{i}}.png" for i in range(4)])
        train_vaegan.main(["data_path=train", "z_dim=8", "d=4",
                           "batch_size=2", "nepoch=1", "steps_per_epoch=1",
                           "num_samples=3"], device="cpu")
        assert os.path.exists("results/vaegan_default/netG.npz")
        with open("m.csv", "w") as f:
            f.write("a,b,c,d\\n" + "\\n".join(
                ",".join(str(int(v)) for v in row)
                for row in rng.integers(0, 2, (20, 4))) + "\\n")
        train_medgan.main(["DATASETPATH=m.csv", "n_epochs=1",
                           "n_epochs_pretrain=1", "batch_size=6",
                           "latent_dim=4", "hidden_gen=4", "generate_N=5",
                           "PATH=model"], device="cpu")
        assert np.load("model/synthetic.npy").shape == (5, 4)
        os.makedirs("train8")
        save_png_batch_native(rng.integers(0, 256, (4, 8, 8, 3), np.uint8),
                              [f"train8/{{i}}.png" for i in range(4)])
        train_pggan.main(["data_path=train8", "image_size=8", "nz=8",
                          "in_channels=8", "batch_sizes=[2]",
                          "num_epochs=1", "num_generated=3", "PATH=model",
                          "PATH_syn_data=syn", "sample_grid_dir=null"],
                         device="cpu")
        assert os.path.isdir("syn/pggan/png_images")
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
    """)
    res = _run_isolated(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_new_victim_entry_points_refuse_without_gpu(monkeypatch, tmp_path):
    """The VAE-GAN, medGAN and PGGAN trainers, samplers and CLIs refuse
    without a GPU unless asked for the CPU."""
    from ganleaks_tpu_torch.cli import train_medgan as cli_medgan
    from ganleaks_tpu_torch.cli import train_pggan as cli_pggan
    from ganleaks_tpu_torch.cli import train_vaegan as cli_vaegan
    from ganleaks_tpu_torch.config import (MedGANConfig, PGGANConfig,
                                           VAEGANConfig)
    from ganleaks_tpu_torch.train import medgan, pggan, vaegan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    imgs = np.zeros((4, 8, 8, 3), np.float32)
    rows = np.zeros((4, 3), np.float32)
    calls = [
        lambda: vaegan.train(VAEGANConfig(), images=imgs),
        lambda: vaegan.sample(VAEGANConfig(), None, str(tmp_path)),
        lambda: medgan.train(MedGANConfig(), data=rows),
        lambda: medgan.generate(MedGANConfig(), None),
        lambda: pggan.train(PGGANConfig(), images=imgs),
        lambda: pggan.generate(PGGANConfig()),
        lambda: cli_vaegan.main([f"data_path={tmp_path}"]),
        lambda: cli_medgan.main(["DATASETPATH=x.csv"]),
        lambda: cli_pggan.main([f"data_path={tmp_path}"]),
        lambda: cli_pggan.main(["--device", "cuda", "training=false"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_privgan_entry_points_refuse_without_gpu(monkeypatch, tmp_path):
    """The privDCGAN / privPGGAN trainers, samplers and CLIs (whose
    ``--device`` defaults to cuda) refuse without a GPU unless asked for
    the CPU."""
    from ganleaks_tpu_torch.cli import train_privdcgan as cli_privdcgan
    from ganleaks_tpu_torch.cli import train_privpggan as cli_privpggan
    from ganleaks_tpu_torch.config import (DCGANConfig, PGGANConfig,
                                           PrivGANConfig)
    from ganleaks_tpu_torch.train import priv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    imgs = np.zeros((4, 16, 16, 3), np.float32)
    dc = DCGANConfig(image_size=16, nz=4, ngf=4, ndf=4)
    pg = PGGANConfig(image_size=8, nz=4, in_channels=4)
    pc = PrivGANConfig()
    calls = [
        lambda: priv.train_privdcgan(dc, pc, images=imgs),
        lambda: priv.generate_privdcgan(dc, pc,
                                        priv.build_privdcgan_state(dc, pc)),
        lambda: priv.train_privpggan(pg, pc, images=imgs[:, :8, :8]),
        lambda: priv.generate_privpggan(pg, pc,
                                        priv.build_privpggan_state(pg, pc)),
        lambda: cli_privdcgan.main([f"data_path={tmp_path}"]),
        lambda: cli_privpggan.main([f"data_path={tmp_path}"]),
        lambda: cli_privdcgan.main(["--device", "cuda", "num_epochs=0"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_parallel_and_dryrun_stand_alone():
    """``parallel/*`` and ``dryrun`` import no JAX, no JAX package and no
    optional library: the dry run on two ``gloo`` ranks works with all of
    them unimportable in the launching process."""
    code = textwrap.dedent("""
        import ganleaks_tpu_torch.parallel.knn_shard
        import ganleaks_tpu_torch.parallel.mesh
        import ganleaks_tpu_torch.parallel.multihost
        from ganleaks_tpu_torch.dryrun import dryrun_multichip
        out = dryrun_multichip(2, device="cpu", timeout_s=300)
        assert out["ranks"] == 2, out
        bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not bad, bad
        print("ok")
    """)
    res = _run_isolated(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_multi_gpu_entry_points_refuse_without_gpu(monkeypatch):
    from ganleaks_tpu_torch.attack.fbb import launch_attack
    from ganleaks_tpu_torch.cli import fid as cli_fid
    from ganleaks_tpu_torch.config import AttackConfig
    from ganleaks_tpu_torch.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: launch_attack(AttackConfig(n_chips=2)),
                 lambda: dryrun_multichip(2),
                 lambda: cli_fid.main(["a.npz", "b.npz", "--n_chips", "2"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
