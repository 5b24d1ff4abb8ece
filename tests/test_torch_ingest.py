"""The port's PNG ingest (``ganleaks_tpu_torch.io.native``, ``io.images``,
``io.diskcache``, ``io.stream`` and their wiring in ``attack.fbb``)
against the JAX package on the CPU.

The port decodes PNGs with its own codec (``csrc/png_codec.cpp``, built
with g++), the JAX package with Pillow or libpng; decoded pixels
and the readers' floats are held bit for bit, on PNGs written by Pillow
at every compression level (so every row filter occurs). Attacks from PNG
directories are held to the same attack from npz files of the same bytes,
exactly (same inputs, same arithmetic)."""

import os
import sys

import numpy as np
import PIL.Image
import pytest
import torch

from ganleaks_tpu.io.images import load_image_dir as j_load_image_dir
from ganleaks_tpu.io.images import read_image as j_read_image
from ganleaks_tpu.io.images import \
    read_image_center_crop as j_read_image_center_crop
from ganleaks_tpu.io.images import save_png as j_save_png
from ganleaks_tpu.io.native import load_image_dir_native as j_load_native
from ganleaks_tpu_torch.attack.fbb import attack_arrays, run_attack
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.io import diskcache, native, stream
from ganleaks_tpu_torch.io.images import (load_image_dir, read_image,
                                          read_image_center_crop, save_png,
                                          to_uint8)

RES = 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Several test processes run at once: one torch thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _structured(rng, n, h, w):
    """Images with flat runs and gradients beside noise, so Pillow's
    adaptive filtering picks every row filter type."""
    img = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    img[:, :, : w // 3] = img[:, :, :1]
    img[:, : h // 3] = np.arange(w, dtype=np.uint8)[None, None, :, None]
    return img


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """PNG directories written by Pillow: 'exact' (24 images at 64 px,
    compression levels 0-9), 'crop' (218 x 178, the CelebA frame the
    center crop reads), 'mixed' (64 px beside other sizes)."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    out = {}
    for name, shapes in (("exact", [(64, 64)] * 24),
                         ("crop", [(218, 178)] * 6),
                         ("mixed", [(64, 64), (40, 50), (64, 64), (97, 31),
                                    (128, 128), (64, 64)])):
        d = root / name
        d.mkdir()
        for i, (h, w) in enumerate(shapes):
            PIL.Image.fromarray(_structured(rng, 1, h, w)[0]).save(
                d / f"img_{i:03d}.png", compress_level=i % 10)
        out[name] = str(d)
    return out


@pytest.mark.parametrize("name,center_crop", [
    ("exact", False), ("crop", False), ("mixed", False), ("exact", True),
    ("crop", True)])  # the center crop needs images of at least 185 x 153
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_load_image_dir_matches_jax(dirs, name, center_crop, dtype):
    """Native decode (plus the resize or crop where sizes differ) equals
    the JAX package's Pillow readers bit for bit."""
    readers = ((read_image_center_crop, j_read_image_center_crop)
               if center_crop else (read_image, j_read_image))
    got = load_image_dir(dirs[name], RES, reader=readers[0], dtype=dtype)
    want = j_load_image_dir(dirs[name], RES, reader=readers[1], dtype=dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_decode_matches_libpng_and_pillow(dirs):
    """The codec's pixels equal libpng's (the JAX package's native loader)
    and Pillow's on every file."""
    got = native.load_image_dir_native(dirs["exact"], RES, dtype=np.uint8)
    np.testing.assert_array_equal(
        got, j_load_native(dirs["exact"], RES, dtype=np.uint8))
    for i, p in enumerate(sorted(os.listdir(dirs["exact"]))):
        path = os.path.join(dirs["exact"], p)
        np.testing.assert_array_equal(native.decode_png(path),
                                      np.asarray(PIL.Image.open(path)))
        np.testing.assert_array_equal(read_image(path, RES),
                                      j_read_image(path, RES))


@pytest.mark.parametrize("level", [0, 1, 9])
def test_encoder_round_trips(tmp_path, level):
    """PNGs the port writes decode to the same pixels in Pillow and in the
    port's codec; odd sizes and a single row included."""
    rng = np.random.default_rng(1)
    for h, w in ((64, 64), (7, 13), (1, 5)):
        imgs = _structured(rng, 3, h, w)
        paths = [str(tmp_path / f"{h}x{w}_{i}.png") for i in range(3)]
        native.save_png_batch_native(imgs, paths, compress_level=level)
        for img, p in zip(imgs, paths):
            np.testing.assert_array_equal(np.asarray(PIL.Image.open(p)), img)
            np.testing.assert_array_equal(native.decode_png(p), img)


def test_encoder_refuses_bad_batches(tmp_path):
    imgs = np.zeros((2, 4, 4, 3), np.float32)
    with pytest.raises(TypeError, match="uint8"):
        native.save_png_batch_native(imgs, ["a.png", "b.png"])
    with pytest.raises(ValueError, match="paths"):
        native.save_png_batch_native(imgs.astype(np.uint8), ["a.png"])


@pytest.mark.parametrize("rounding", ["floor", "rint"])
def test_save_png_matches_jax(tmp_path, rounding):
    """``save_png`` / ``to_uint8``: the JAX package's floor (ToPILImage)
    and rint quantisation, pixel for pixel."""
    img = np.random.default_rng(2).uniform(-0.1, 1.1, (16, 16, 3))
    save_png(img, str(tmp_path / "port.png"), rounding=rounding)
    j_save_png(img, str(tmp_path / "jax.png"), rounding=rounding)
    np.testing.assert_array_equal(
        native.decode_png(str(tmp_path / "port.png")),
        np.asarray(PIL.Image.open(tmp_path / "jax.png")))
    np.testing.assert_array_equal(to_uint8(img, (0.0, 1.0), rounding),
                                  native.decode_png(str(tmp_path /
                                                        "port.png")))


def test_mismatched_size_needs_pillow(dirs, monkeypatch):
    """A PNG whose size differs from the resolution is resized through
    Pillow; without Pillow that raises naming the file, and exact-size
    PNGs still load."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="img_001.png.*Pillow"):
        load_image_dir(dirs["mixed"], RES)
    assert load_image_dir(dirs["exact"], RES).shape == (24, RES, RES, 3)
    # the center crop is numpy: no Pillow needed
    assert load_image_dir(dirs["crop"], RES,
                          reader=read_image_center_crop).shape[0] == 6


@pytest.mark.parametrize("form", ["RGBA", "L", "P", "I;16", "interlaced",
                                  "not_png", "truncated"])
def test_codec_refuses_other_forms(tmp_path, form):
    """Only 8-bit RGB non-interlaced PNGs decode; anything else raises a
    ValueError naming the file."""
    path = str(tmp_path / "x.png")
    rgb = np.random.default_rng(3).integers(0, 256, (8, 8, 3), np.uint8)
    if form == "not_png":
        with open(path, "wb") as f:
            f.write(b"GIF89a" + bytes(100))
    elif form == "truncated":
        native.encode_png(rgb, path)
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[:60])
    elif form == "interlaced":  # Pillow writes no Adam7 PNG: patch IHDR
        native.encode_png(rgb, path)
        data = bytearray(open(path, "rb").read())
        data[28] = 1  # IHDR's interlace byte (the CRC is not checked)
        with open(path, "wb") as f:
            f.write(bytes(data))
    elif form == "I;16":
        PIL.Image.fromarray(rgb[..., 0].astype(np.uint16) * 257).save(path)
    else:
        PIL.Image.fromarray(rgb).convert(form).save(path)
    with pytest.raises(ValueError, match="x.png"):
        native.decode_png(path)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler failure raises with its output; nothing falls back."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    path = str(tmp_path / "x.png")
    PIL.Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path)
    with pytest.raises(RuntimeError, match="failed to build"):
        native.decode_png(path)
    with pytest.raises(RuntimeError, match="failed to build"):
        native.encode_png(np.zeros((4, 4, 3), np.uint8), path)


def test_decode_cache_publish_reuse_gc(dirs, tmp_path, monkeypatch):
    """First load decodes and publishes (npy + sidecar); the second reads
    the memmap; a touched file misses; GC keeps the newest entries."""
    cache = str(tmp_path / "cache")
    want = j_load_image_dir(dirs["exact"], RES, dtype=np.uint8)
    calls = []
    real = native.load_image_paths_native

    def counting(paths, *a, **k):
        calls.append(len(paths))
        return real(paths, *a, **k)

    monkeypatch.setattr(native, "load_image_paths_native", counting)
    a = diskcache.load_image_dir_cached(dirs["exact"], RES, dtype=np.uint8,
                                        policy=cache)
    np.testing.assert_array_equal(a, want)
    files = os.listdir(cache)
    assert sum(f.endswith(".npy") for f in files) == 1
    assert sum(f.endswith(".json") for f in files) == 1
    b = diskcache.load_image_dir_cached(dirs["exact"], RES, dtype=np.uint8,
                                        policy=cache)
    assert isinstance(b, np.memmap) and calls == [24]
    np.testing.assert_array_equal(b, want)
    # another dtype and a limit are other keys; _KEEP = 2 keeps two entries
    monkeypatch.setattr(diskcache, "_KEEP", 2)
    f32 = diskcache.load_image_dir_cached(dirs["exact"], RES, policy=cache)
    np.testing.assert_array_equal(f32, j_load_image_dir(dirs["exact"], RES))
    diskcache.load_image_dir_cached(dirs["exact"], RES, limit=5,
                                    dtype=np.uint8, policy=cache)
    assert sum(f.endswith(".json") for f in os.listdir(cache)) == 2
    # off: nothing written
    diskcache.load_image_dir_cached(dirs["mixed"], RES, policy="off")
    assert not os.path.exists(os.path.join(dirs["mixed"],
                                           ".ganleaks_decoded"))
    # a touched file is a new key: decoded again
    first = os.path.join(dirs["exact"], "img_000.png")
    st = os.stat(first)
    os.utime(first, ns=(st.st_atime_ns, st.st_mtime_ns + 1000))
    n_calls = len(calls)
    diskcache.load_image_dir_cached(dirs["exact"], RES, dtype=np.uint8,
                                    policy=cache)
    assert len(calls) == n_calls + 1


def test_host_image_set_matches_eager(dirs, tmp_path, monkeypatch):
    """Slices, rows, negative rows, index arrays, boolean masks, strided
    slices and ``limit`` equal the eager array; with the decoded-row cache
    every row decodes once, and the next set reads the published disk
    cache without decoding."""
    eager = load_image_dir(dirs["exact"], RES, dtype=np.uint8)
    decoded = []
    real = stream.load_image_paths_native

    def counting(paths, *a, **k):
        decoded.extend(paths)
        return real(paths, *a, **k)

    monkeypatch.setattr(stream, "load_image_paths_native", counting)
    cache = str(tmp_path / "c")
    x = stream.HostImageSet(dirs["exact"], RES, disk_cache=cache)
    assert len(x) == 24 and x.shape == eager.shape
    assert x.nbytes == eager.nbytes and x.dtype == np.uint8
    np.testing.assert_array_equal(x[0:8], eager[0:8])
    np.testing.assert_array_equal(x[8:16], eager[8:16])  # readahead
    np.testing.assert_array_equal(x[5], eager[5])
    np.testing.assert_array_equal(x[-1], eager[-1])
    idx = np.array([23, 3, 4, 5, 0, 3])
    np.testing.assert_array_equal(x[idx], eager[idx])
    mask = np.arange(24) % 3 == 0
    np.testing.assert_array_equal(x[mask], eager[mask])
    np.testing.assert_array_equal(x[1:20:4], eager[1:20:4])
    np.testing.assert_array_equal(x.limit(10)[6:10], eager[6:10])
    assert len(x.limit(10)) == 10
    np.testing.assert_array_equal(np.asarray(x), eager)
    assert sorted(decoded) == sorted(set(decoded))  # each row once
    with pytest.raises(IndexError):
        x[24]
    decoded.clear()
    y = stream.HostImageSet(dirs["exact"], RES, disk_cache=cache)
    np.testing.assert_array_equal(y[0:24], eager)
    assert decoded == []


def _write_sets(root, rng):
    """pos / neg / two synthetic subdirs, each as a PNG dir and an npz of
    the same bytes; members' noisy copies planted in the synthetic sets."""
    sets = {"pos": rng.integers(0, 256, (6, 32, 32, 3), np.uint8),
            "neg": rng.integers(0, 256, (6, 32, 32, 3), np.uint8)}
    for k in ("a", "b"):
        syn = rng.integers(0, 256, (20, 32, 32, 3), np.uint8)
        noise = rng.integers(-6, 7, (6, 32, 32, 3))
        syn[[1, 4, 7, 9, 15, 18]] = np.clip(
            sets["pos"].astype(int) + noise, 0, 255)
        sets[k] = syn
    for name, arr in sets.items():
        d = (root / "png" / "syn" / name if name in ("a", "b")
             else root / "png" / name)
        d.mkdir(parents=True)
        native.save_png_batch_native(
            arr, [str(d / f"image_{i:03d}.png") for i in range(len(arr))])
        target = (root / "npz" / "syn" / name / "images.npz"
                  if name in ("a", "b") else root / "npz" / f"{name}.npz")
        target.parent.mkdir(parents=True, exist_ok=True)
        np.savez(target, images=arr)
    return sets


@pytest.mark.parametrize("decode_cache,host_stream", [
    (False, "auto"), ("auto", "auto"), (False, True), ("auto", True)])
def test_run_attack_png_dirs_equal_npz(tmp_path, monkeypatch, decode_cache,
                                       host_stream):
    """``run_attack`` over a hyperparameter sweep of PNG subdirs gives the
    npz route's indices and losses exactly, with the decode cache and
    ``HostImageSet`` on and off; the sweep skips ``.ganleaks_decoded``,
    and ``save_plots`` writes the closest pairs through the encoder."""
    monkeypatch.chdir(tmp_path)
    _write_sets(tmp_path, np.random.default_rng(4))
    # a cache dir at the sweep root, as a cached run leaves in each set
    hidden = tmp_path / "png" / "syn" / ".ganleaks_decoded"
    hidden.mkdir()
    native.encode_png(np.zeros((32, 32, 3), np.uint8),
                      str(hidden / "stray.png"))
    base = dict(resolution=32, distance="l2", engine="gemm",
                hyperparameter_search=True, params="x", syn_block=8,
                query_block=4)
    outs = {}
    for fmt in ("npz", "png"):
        cfg = AttackConfig(
            syn_data_path=str(tmp_path / fmt / "syn"),
            pos_data_dir=str(tmp_path / fmt / ("pos.npz" if fmt == "npz"
                                               else "pos")),
            neg_data_dir=str(tmp_path / fmt / ("neg.npz" if fmt == "npz"
                                               else "neg")),
            exp_name=fmt, decode_cache=decode_cache, host_stream=host_stream,
            save_plots=fmt == "png", **base)
        outs[fmt] = run_attack(cfg, device="cpu")
        if fmt == "png" and decode_cache == "auto":
            # again, from the cache
            outs["png2"] = run_attack(cfg, device="cpu")
    assert len(outs["png"]) == 2
    for fmt in [f for f in outs if f != "npz"]:
        for got, want in zip(outs[fmt], outs["npz"]):
            for key in ("pos_nn_idx", "neg_nn_idx", "pos_loss", "neg_loss"):
                np.testing.assert_array_equal(got[key], want[key])
    assert outs["npz"][0]["pos_nn_idx"].tolist() == [1, 4, 7, 9, 15, 18]
    plot = os.path.join(outs["png"][0]["save_dir"], "0pos.png")
    assert native.decode_png(plot).shape == (32, 64, 3)
    cached = os.path.isdir(tmp_path / "png" / "pos" / ".ganleaks_decoded")
    assert cached == (decode_cache == "auto")


def test_host_image_set_two_pass_and_resweep(tmp_path, monkeypatch):
    """A ``HostImageSet`` feeds the two-pass search (its candidate gather
    indexes the set with an array) and a multi-sweep schedule (a query
    cache of one block): results equal the eager array's, and each row is
    decoded once."""
    sets = _write_sets(tmp_path, np.random.default_rng(5))
    decoded = []
    real = stream.load_image_paths_native

    def counting(paths, *a, **k):
        decoded.extend(paths)
        return real(paths, *a, **k)

    monkeypatch.setattr(stream, "load_image_paths_native", counting)
    cfg = AttackConfig(resolution=32, distance="l2-lpips", engine="taps",
                       two_pass=True, query_block=4, syn_block=8,
                       query_cache_gb=1e-7, auto_plan=False,
                       save_plots=False)
    syn = stream.HostImageSet(str(tmp_path / "png" / "syn" / "a"), 32,
                              disk_cache=False)
    got = attack_arrays(cfg, syn, sets["pos"], sets["neg"], device="cpu")
    want = attack_arrays(cfg, sets["a"], sets["pos"], sets["neg"],
                         device="cpu")
    assert got["plan"]["sweeps"] > 1
    for key in ("pos_nn_idx", "neg_nn_idx", "pos_loss", "neg_loss"):
        np.testing.assert_array_equal(got[key], want[key])
    assert len(decoded) == len(set(decoded)) == 20
