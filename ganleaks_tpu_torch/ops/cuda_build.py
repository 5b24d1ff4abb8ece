"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``_build/lib<name>-<digest>.so`` inside the
package, where ``<digest>`` hashes the source, every ``csrc/*.cuh`` header
and the flags, so an edited source or header never loads a stale library.
``nvcc``'s ``-Xptxas -v`` report (registers, shared memory, spills per
kernel) is kept beside the library as ``.log``. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# every kernel source of the port; build_all() compiles them in parallel
SOURCES = ("knn_argmin", "knn_topk", "tap_epilogue", "knn_int8_fold",
           "bias_relu_pool")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put "
                           "nvcc on PATH) to build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (process, temp output, final path, log path) or None."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = out[:-3] + ".log"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, log


def _finish_build(name: str, job) -> None:
    proc, tmp, out, log = job
    text, _ = proc.communicate()
    with open(log, "w") as f:
        f.write(text)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{text}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> dict[str, float]:
    """Compile every kernel source at once (one nvcc each, started
    together); returns wall seconds per source (0.0 when already built)."""
    with _LOCK:
        t0 = time.perf_counter()
        jobs = {name: _start_build(name) for name in SOURCES}
        secs = {}
        for name, job in jobs.items():
            if job is not None:
                _finish_build(name, job)
            secs[name] = time.perf_counter() - t0 if job is not None else 0.0
        return secs


def build_log(name: str) -> str:
    """nvcc's report for the built ``name`` ('' before its first build)."""
    log = library_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            lib = _LIBS[name] = ctypes.CDLL(library_path(name))
        return lib
