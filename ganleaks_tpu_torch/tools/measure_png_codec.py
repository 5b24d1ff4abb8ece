"""Measure the port's PNG codec (``io/native``) on this machine: encode,
decode and ``stat`` throughput at several thread counts, on seeded 64-px
images written under ``$TMPDIR`` (removed afterwards), and the file
system they live on.

    python -m ganleaks_tpu_torch.tools.measure_png_codec
    python -m ganleaks_tpu_torch.tools.measure_png_codec --n 20000 \\
        --threads 1 8 16 32

Prints one JSON line: the file system type (from ``/proc/mounts``),
images/s per operation and thread count, and a check that the decoded
pixels equal the encoded ones. The codec needs no GPU; this tool runs
wherever it builds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np


def mount_type(path: str) -> str:
    """The type of the file system holding ``path`` (longest mount
    point prefix in ``/proc/mounts``), or 'unknown'."""
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3 and (path == parts[1] or path.startswith(
                        parts[1].rstrip("/") + "/")) and len(parts[1]) > len(
                        best):
                    best, kind = parts[1], parts[2]
    except OSError:
        pass
    return kind


def seeded_images(n: int, seed: int, res: int = 64) -> np.ndarray:
    """uint8 NHWC: an 8x8 random layout upsampled, plus pixel noise (the
    distribution of ``chip_smoke.py``'s attack sets)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.int16)
    up = np.repeat(np.repeat(base, res // 8, axis=1), res // 8, axis=2)
    noise = rng.integers(-24, 25, up.shape, dtype=np.int16)
    return np.clip(up + noise, 0, 255).astype(np.uint8)


def main(argv=None) -> dict:
    from ganleaks_tpu_torch.io import native

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 8, 16])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    native._library()
    build_s = time.perf_counter() - t0
    imgs = seeded_images(args.n, args.seed)
    d = tempfile.mkdtemp()
    rec = {"fs": mount_type(d), "n": args.n, "build_s": build_s,
           "cpu_count": os.cpu_count()}
    try:
        paths = [os.path.join(d, f"image_{i:06d}.png")
                 for i in range(args.n)]
        for nt in args.threads:
            t0 = time.perf_counter()
            native.save_png_batch_native(imgs, paths, num_threads=nt)
            rec[f"encode_per_s_{nt}"] = args.n / (time.perf_counter() - t0)
        ok = True
        for nt in args.threads:
            t0 = time.perf_counter()
            out = native.load_image_paths_native(paths, 64, num_threads=nt,
                                                 dtype=np.uint8)
            rec[f"decode_per_s_{nt}"] = args.n / (time.perf_counter() - t0)
            ok = ok and bool((out == imgs).all())
        for nt in args.threads:
            t0 = time.perf_counter()
            native.stat_paths(paths, nt)
            rec[f"stat_per_s_{nt}"] = args.n / (time.perf_counter() - t0)
        rec["pixels_equal"] = ok
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
