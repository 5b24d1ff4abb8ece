"""The PyTorch port stands alone: no module of ``ganleaks_tpu_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, optional libraries load
lazily, the main path runs with torch, numpy and the standard library
alone, and entry points refuse to run without a GPU unless asked for the
CPU."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ganleaks_tpu_torch")
LAZY = ("yaml", "PIL", "matplotlib", "wandb")
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
        BLOCKED = {FORBIDDEN + LAZY + ("scipy",)!r}

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
