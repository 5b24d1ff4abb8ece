"""Measure the float32 route of the fused kNN kernels (K1
``csrc/knn_argmin.cu``, K3 ``csrc/knn_topk.cu``) on the card: what ptxas
made of each kernel (registers, spills, shared memory), how many blocks of
it fit on an SM (the CUDA occupancy API), and its time beside its bounds,
its plain version and one PyTorch call composition, at the shapes the
port's main paths give it:

* K1 and K3 (k = 4) at the attack's block, 2,048 x 2,048, K = 512,000;
* K1 at the tabular attack's 4,652 x 10,000, K = 1,071 (medGAN's MIMIC-III
  width), with the zero-padded copy TMA needs inside the timed call.

    python -m ganleaks_tpu_torch.tools.bench_knn_f32
    python ganleaks_tpu_torch/tools/bench_knn_f32.py \\
        --roots .chipcheck/parent . . .chipcheck/parent \\
        --probe 'knn_argmin.cu|knn_partial_kernel<true>|256|0'

``--roots`` measures the package of each listed checkout in turn, each in
a process of its own (``PYTHONPATH`` set to it), so two versions are
compared on one card within one call. ``--probe FILE|KERNEL|THREADS|SMEM``
asks the occupancy API about ``KERNEL`` at ``THREADS`` threads and ``SMEM``
bytes of dynamic shared memory, both C++ expressions compiled into a probe
library that includes ``csrc/FILE``; the default probes name the current
tree's kernels at the shared memory their launches ask for. Prints one JSON line per
root and measurement, each with the card's name and power limit. Needs a
CUDA device and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# NVIDIA H100 SXM data sheet (dense, 700 W)
PEAK_FP32_FLOPS = 67e12    # float32 on the CUDA cores (an FFMA design)
PEAK_TF32_FLOPS = 495e12   # TF32 on the tensor cores (3 products per MAC)
PEAK_HBM_BYTES = 3.35e12

# (file, kernel expression, threads, dynamic shared memory bytes) of the
# float32 kernels: the 3xTF32 tile's ring of 6 stages (K1; K3 at k = 4 with
# its 4 KB of lists) and of 3 stages beside K3's k = 128 lists
DEFAULT_PROBES = (
    "knn_argmin.cu|knn_partial_wgmma<knn_tf32x3::Tile>|384|197776",
    "knn_topk.cu|knn_topk_partial_wgmma<knn_tf32x3::Tile>|384|201872",
    "knn_topk.cu|knn_topk_partial_wgmma<knn_tf32x3::Tile>|384|230472",
)

MAIN = (2048, 2048, 512000)
TABULAR = (4652, 10000, 1071)
TOPK_K = 4


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list[dict]:
    """Registers, spills and shared memory per entry function in nvcc's
    ``-Xptxas -v`` output."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return out


def occupancy(root: str, probes: list[str]) -> list[dict]:
    """Blocks per SM of each probe (module docstring), from the CUDA
    occupancy API; one probe library per source file."""
    from ganleaks_tpu_torch.ops import cuda_build

    by_file: dict[str, list[tuple[int, str, int, str]]] = {}
    for i, spec in enumerate(probes):
        fname, expr, threads, smem = spec.split("|")
        by_file.setdefault(fname, []).append((i, expr, int(threads), smem))
    out: list[dict] = [{} for _ in probes]
    for fname, items in by_file.items():
        src = ["#include <cuda_runtime.h>",
               f'#include "{os.path.join(cuda_build.CSRC_DIR, fname)}"']
        for i, expr, threads, smem in items:
            src += [f'extern "C" int probe_{i}(int* smem) {{',
                    f"  auto k = {expr};",
                    f"  *smem = static_cast<int>({smem});",
                    "  int n = 0;",
                    "  cudaError_t e = cudaFuncSetAttribute(k, "
                    "cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);",
                    "  if (e != cudaSuccess) return -static_cast<int>(e);",
                    "  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor("
                    f"&n, k, {threads}, *smem);",
                    "  return e == cudaSuccess ? n : -static_cast<int>(e);",
                    "}"]
        text = "\n".join(src) + "\n"
        tag = hashlib.sha256(text.encode()).hexdigest()[:12]
        os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
        base = os.path.join(cuda_build.BUILD_DIR, f"probe-{tag}")
        with open(base + ".cu", "w") as f:
            f.write(text)
        flags = [a for a in cuda_build.NVCC_FLAGS if a not in ("-Xptxas",
                                                                "-v")]
        subprocess.run([cuda_build._nvcc(), *flags, "-o", base + ".so",
                        base + ".cu"], check=True, capture_output=True)
        lib = ctypes.CDLL(base + ".so")
        for i, expr, threads, smem in items:
            fn = getattr(lib, f"probe_{i}")
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            nbytes = ctypes.c_int(0)
            blocks = fn(ctypes.byref(nbytes))
            out[i] = {"file": fname, "kernel": expr, "threads": threads,
                      "dynamic_smem": nbytes.value, "blocks_per_sm": blocks}
    return out


def time_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bounds(n_q: int, n_s: int, k_dim: int, out_bytes: int) -> dict:
    """Both float32 bounds: the CUDA cores' and the 3xTF32 tensor cores',
    each the larger of its operations and the bytes over 3.35 TB/s."""
    flops = 2.0 * n_q * n_s * k_dim
    t_bytes = ((n_q + n_s) * (k_dim + 1) * 4 + out_bytes) \
        / PEAK_HBM_BYTES * 1e3
    return {"flops": flops,
            "ffma_bound_ms": max(flops / PEAK_FP32_FLOPS * 1e3, t_bytes),
            "tf32x3_bound_ms": max(3 * flops / PEAK_TF32_FLOPS * 1e3,
                                   t_bytes),
            "bytes_bound_ms": t_bytes}


def timing(torch, label: str, shape, k: int | None, reps: int) -> dict:
    """One kernel at ``shape``: (kernel, plain, library, kernel) in turns."""
    from ganleaks_tpu_torch.ops import knn_fused as kf

    n_q, n_s, k_dim = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((n_q, k_dim), generator=gen, device="cuda") / k_dim ** .5
    s = torch.randn((n_s, k_dim), generator=gen, device="cuda") / k_dim ** .5
    rq, rs = kf.sq_norms(q), kf.sq_norms(s)
    if k is None:
        def kernel():
            return kf.knn_argmin_fused(q, s, rq=rq, rs=rs)

        def plain():
            return kf.knn_argmin_plain(q, s, rq, rs)

        def library():
            return torch.min(torch.addmm(rs[None, :], q, s.T, alpha=-2.0)
                             + rq[:, None], dim=1)
        out_bytes = n_q * 8
    else:
        def kernel():
            return kf.knn_topk_fused(q, s, k, rq=rq, rs=rs)

        def plain():
            return kf.knn_topk_plain(q, s, k, rq, rs)

        def library():
            return torch.topk(torch.addmm(rs[None, :], q, s.T, alpha=-2.0)
                              + rq[:, None], k, dim=1, largest=False)
        out_bytes = n_q * k * 8
    fn = kf.knn_argmin_fused if k is None else kf.knn_topk_fused
    before = dict(fn.launches_by_route)
    ms1 = time_ms(torch, kernel, reps)
    plain_ms = time_ms(torch, plain, reps)
    library_ms = time_ms(torch, library, reps)
    ms2 = time_ms(torch, kernel, reps)
    routes = {r: n - before.get(r, 0) for r, n in
              fn.launches_by_route.items() if n - before.get(r, 0)}
    res = {"case": label, "n_q": n_q, "n_s": n_s, "k_dim": k_dim, "k": k,
           "routes": routes, "ms": min(ms1, ms2), "ms_runs": [ms1, ms2],
           "plain_ms": plain_ms, "library_ms": library_ms,
           **bounds(n_q, n_s, k_dim, out_bytes)}
    res["tflops"] = res["flops"] / (res["ms"] * 1e-3) / 1e12
    if k_dim % 4:
        # the zero-padded copy of q and s (to K % 4 == 0) alone
        def pad():
            return (torch.nn.functional.pad(q, (0, -k_dim % 4)),
                    torch.nn.functional.pad(s, (0, -k_dim % 4)))
        res["pad_copy_ms"] = time_ms(torch, pad, reps)
    return res


def measure_one(root: str, probes: list[str]) -> None:
    import torch

    from ganleaks_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        raise SystemExit("bench_knn_f32: no CUDA device")
    head = {"root": root, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi_line()}
    for name in ("knn_argmin", "knn_topk"):
        cuda_build.load_library(name)
        print(json.dumps({**head, "what": "ptxas", "library": name,
                          "entries": ptxas_report(
                              cuda_build.build_log(name))}), flush=True)
    print(json.dumps({**head, "what": "occupancy",
                      "probes": occupancy(root, probes)}), flush=True)
    for label, shape, k, reps in (("k1_main", MAIN, None, 3),
                                  ("k3_main", MAIN, TOPK_K, 3),
                                  ("k1_tabular", TABULAR, None, 20)):
        print(json.dumps({**head, "what": "timing",
                          **timing(torch, label, shape, k, reps)}),
              flush=True)
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+", default=None,
                    help="checkouts to measure in turn (default: this one)")
    ap.add_argument("--probe", action="append", default=None,
                    help="FILE|KERNEL|THREADS|SMEM (repeatable)")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    probes = args.probe or list(DEFAULT_PROBES)
    if args.one is not None:
        measure_one(args.one, probes)
        return 0
    rc = 0
    for root in args.roots or [REPO]:
        root = os.path.abspath(root)
        env = {**os.environ, "PYTHONPATH": root}
        cmd = [sys.executable, os.path.abspath(__file__), "--one", root]
        for p in probes:
            cmd += ["--probe", p]
        rc |= subprocess.run(cmd, env=env, cwd=root).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
