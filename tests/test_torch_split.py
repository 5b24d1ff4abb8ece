"""The port's data preparation and host helpers against the JAX package on
the CPU: the CelebA split (``tools/z_split``, ``cli/split``), the
matplotlib plots (``attack/viz``), the FID directory loader
(``ops/fid._load_path_images``), ``ops/roc.auroc`` and
``ops/knn.knn_argmin_reference_batched``.

The split must equal the JAX package's bit for bit: the same file names
per directory, the same decoded pixels and the same packs (the PNG bytes
differ: the port's encoder). ``auroc`` is held to the ROC tests' 1e-6
(float32 sums in JAX, float64 in the port); the batched reference search
to the same indices and float32 distances within 1e-6 relative.
"""

import os

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from ganleaks_tpu.attack import viz as j_viz
from ganleaks_tpu.cli import split as j_cli_split
from ganleaks_tpu.config import SplitConfig as JSplitConfig
from ganleaks_tpu.ops.knn import \
    knn_argmin_reference_batched as j_reference_batched
from ganleaks_tpu.ops.roc import auroc as j_auroc
from ganleaks_tpu.tools.z_split import run_split as j_run_split
from ganleaks_tpu_torch.attack import viz
from ganleaks_tpu_torch.cli import split as cli_split
from ganleaks_tpu_torch.config import SplitConfig
from ganleaks_tpu_torch.io.native import save_png_batch_native
from ganleaks_tpu_torch.ops.fid import _load_path_images
from ganleaks_tpu_torch.ops.knn import knn_argmin_reference_batched
from ganleaks_tpu_torch.ops.roc import auroc
from ganleaks_tpu_torch.tools.z_split import run_split

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several processes
    yield
    torch.set_num_threads(n)


def make_fake_celeba(tmp_path, rng, n_private_ids=3, n_public=8,
                     num_same_id=4, first="identity"):
    """Synthetic 178x218 'CelebA' + identity annotations (a copy of
    ``tests/test_fid_split.py``'s helper; ``first='filename'`` writes the
    official file's swapped columns)."""
    img_dir = tmp_path / "celeba"
    os.makedirs(img_dir)
    lines = []
    idx = 0
    for ident in range(1, n_private_ids + 1):   # exactly num_same_id each
        for _ in range(num_same_id):
            name = f"{idx:06d}.jpg"
            arr = rng.integers(0, 255, (218, 178, 3), dtype=np.uint8)
            PIL.Image.fromarray(arr).save(img_dir / name)
            lines.append(f"{ident} {name}")
            idx += 1
    for j in range(n_public):                    # 1 image each (< num_same)
        name = f"{idx:06d}.jpg"
        arr = rng.integers(0, 255, (218, 178, 3), dtype=np.uint8)
        PIL.Image.fromarray(arr).save(img_dir / name)
        lines.append(f"{1000 + j} {name}")
        idx += 1
    if first == "filename":
        lines = [" ".join(ln.split()[::-1]) for ln in lines]
    ann = tmp_path / "ann.txt"
    ann.write_text("\n".join(lines) + "\n")
    return str(img_dir), str(ann)


def _split_kwargs(tmp_path, img_dir, ann, tag, **kw):
    return dict(identity_annotations=ann, input_dir=img_dir,
                output_dir0=str(tmp_path / tag / "train"),
                output_dir1=str(tmp_path / tag / "pos"),
                output_dir2=str(tmp_path / tag / "neg"), **kw)


def _read(d: str) -> dict:
    """{name: pixels} of every PNG in ``d`` (Pillow) and the packs."""
    out = {f: np.asarray(PIL.Image.open(os.path.join(d, f)))
           for f in sorted(os.listdir(d)) if f.endswith(".png")}
    for f in os.listdir(d):
        if f.endswith(".npy"):
            out[f] = np.load(os.path.join(d, f))
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_split_equals_the_jax_split(tmp_path, seed):
    rng = np.random.default_rng(seed)
    img_dir, ann = make_fake_celeba(tmp_path, rng)
    kw = dict(num_images=30, num_same_id=4, seed=seed)
    ref = j_run_split(JSplitConfig(**_split_kwargs(tmp_path, img_dir, ann,
                                                   "jax", **kw)))
    # a stale file in an output dir is cleared, as in the JAX package
    stale = tmp_path / "port" / "train"
    os.makedirs(stale)
    (stale / "stale.png").write_bytes(b"x")
    got = run_split(SplitConfig(**_split_kwargs(tmp_path, img_dir, ann,
                                                "port", **kw)))
    assert got == ref == {"members": 10, "non_members": 8}
    for sub in ("train", "pos", "neg"):
        a = _read(str(tmp_path / "jax" / sub))
        b = _read(str(tmp_path / "port" / sub))
        assert sorted(a) == sorted(b), sub
        for name in a:
            np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    train = os.listdir(tmp_path / "port" / "train")
    assert sum(f.endswith("_a1.png") for f in train) == 10
    assert sum(f.endswith("_a2.png") for f in train) == 10


@pytest.mark.parametrize("case", ["num_images_31", "filename_first",
                                  "empty_member_pool"])
def test_split_refuses_as_the_jax_split_does(tmp_path, rng, case):
    img_dir, ann = make_fake_celeba(
        tmp_path, rng, first="filename" if case == "filename_first"
        else "identity")
    kw = {"num_images_31": dict(num_images=31, num_same_id=4),
          "filename_first": dict(num_images=30, num_same_id=4),
          "empty_member_pool": dict(num_images=30, num_same_id=5)}[case]
    errors = []
    for cls, fn, tag in ((JSplitConfig, j_run_split, "jax"),
                         (SplitConfig, run_split, "port")):
        with pytest.raises((AssertionError, ValueError)) as exc:
            fn(cls(**_split_kwargs(tmp_path, img_dir, ann, tag, **kw)))
        errors.append((type(exc.value), str(exc.value)))
    assert errors[0] == errors[1]


def test_split_cli_overrides(tmp_path, rng, capsys):
    img_dir, ann = make_fake_celeba(tmp_path, rng)
    printed = []
    for main, tag in ((j_cli_split.main, "jax"), (cli_split.main, "port")):
        kw = _split_kwargs(tmp_path, img_dir, ann, tag, num_images=30,
                           num_same_id=4, seed=3)
        main([f"{k}={v}" for k, v in kw.items()])
        printed.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed[0] == printed[1] == "members: 10  non-members: 8"
    for sub in ("train", "pos", "neg"):
        a = _read(str(tmp_path / "jax" / sub))
        b = _read(str(tmp_path / "port" / sub))
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_array_equal(b[name], a[name])


@pytest.mark.parametrize("where", ["numpy", "tensor"])
def test_inverse_transform_equals_jax(rng, where):
    imgs = rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    arg = torch.from_numpy(imgs) if where == "tensor" else imgs
    np.testing.assert_array_equal(viz.inverse_transform(arg),
                                  j_viz.inverse_transform(imgs))


@pytest.mark.parametrize("plot", ["gt", "progress", "samples"])
def test_viz_writes_its_file(tmp_path, rng, plot):
    pytest.importorskip("matplotlib")
    imgs = rng.uniform(-1, 1, (7, 8, 8, 3)).astype(np.float32)
    if plot == "gt":
        path = viz.visualize_gt(torch.from_numpy(imgs), str(tmp_path))
        name = "input.png"
    elif plot == "progress":
        path = viz.visualize_progress(imgs, torch.arange(7.0),
                                      str(tmp_path), 3)
        name = "output_3.png"
    else:
        path = viz.visualize_samples(torch.from_numpy(imgs / 2 + 0.5)
                                     .to(torch.bfloat16), str(tmp_path))
        name = "samples.png"
    assert path == os.path.join(str(tmp_path), name)
    assert os.path.getsize(path) > 0
    assert np.asarray(PIL.Image.open(path)).ndim == 3


@pytest.mark.parametrize("jpgs", [0, 2])
def test_fid_loader_equals_pillow(tmp_path, rng, jpgs):
    """PNGs through the port's codec, JPEGs through Pillow, in the JAX
    package's order (the jpg glob, then the png glob): the arrays Pillow
    reads, bit for bit."""
    for i in range(jpgs):
        PIL.Image.fromarray(rng.integers(0, 256, (16, 16, 3), np.uint8)
                            ).save(tmp_path / f"j{i}.jpg")
    save_png_batch_native(rng.integers(0, 256, (3, 16, 16, 3), np.uint8),
                          [str(tmp_path / f"p{i}.png") for i in range(3)])
    import pathlib
    files = (list(pathlib.Path(tmp_path).glob("*.jpg"))
             + list(pathlib.Path(tmp_path).glob("*.png")))
    ref = np.array([np.asarray(PIL.Image.open(str(fn)), dtype=np.float32)
                    for fn in files])
    got = _load_path_images(str(tmp_path))
    assert got.dtype == np.float32 and got.shape == (jpgs + 3, 16, 16, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [1, 2])
def test_auroc_equals_jax(seed):
    rng = np.random.default_rng(seed)
    pos = rng.integers(-4, 3, 40).astype(np.float32) / 4  # tied scores
    neg = rng.integers(-5, 2, 50).astype(np.float32) / 4
    got = auroc(pos, neg)
    assert isinstance(got, float)
    assert got == pytest.approx(float(j_auroc(jnp.asarray(pos),
                                              jnp.asarray(neg))), abs=TOL)


@pytest.mark.parametrize("batch", [3, 4])
def test_reference_batched_equals_jax(rng, batch):
    q = rng.normal(size=(5, 24)).astype(np.float32)
    s = rng.normal(size=(10, 24)).astype(np.float32)  # 10 % batch != 0
    s[7] = q[2] + 1e-3  # the nearest row of q[2] sits in the dropped tail
    d, i = knn_argmin_reference_batched(torch.from_numpy(q),
                                        torch.from_numpy(s), batch)
    jd, ji = j_reference_batched(jnp.asarray(q), jnp.asarray(s), batch)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert int(i.max()) < 10 // batch * batch
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=TOL)
