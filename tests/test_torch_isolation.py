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
        import sys
        sys.path.insert(0, {REPO!r})
        BLOCKED = {FORBIDDEN + LAZY!r}

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {{name}}")
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
    unimportable. (The 2AFC trainer is left out: ``torch.optim`` probes
    for pandas itself, which this blocker refuses rather than reports
    missing.)"""
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
