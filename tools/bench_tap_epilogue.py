#!/usr/bin/env python3
"""Time the port's LPIPS tap epilogue kernel (K2, ``csrc/tap_epilogue.cu``)
on one CUDA GPU at the main path's shapes, optionally beside another build
of the same C interface, and count the slow-pipe instructions in each
build's machine code.

    python3 tools/bench_tap_epilogue.py [--compare NAME=OTHER.cu ...] [--no-timing]

For each library: per kernel, the registers and spills from nvcc's
``-Xptxas -v`` and the static count of each opcode of the 16-per-clock
pipe (MUFU, the F2F/F2I/I2F/FRND conversions, FCHK, F2FP) from
``cuobjdump -sass``, beside the kernel's instruction count; for
``csrc/tap_epilogue.cu`` also a build with ``-DTAP_EPILOGUE_FAST_ONLY``,
which leaves out the reference path, so that its counts are those of the
fast path (each instruction outside the unrolled 32-element chunk code
runs at most once per chunk). Then per mode (bf16 -> int8, float32 ->
float32) and per 64-px VGG16 tap of a 2,048-image block (channels-last,
relu'd normal values, a lin-head-like scale): ms of each library timed in
turns (the libraries in order, then in reverse), GB/s, and the share of
the byte bound at 3.35 TB/s. The parts and row norms of every library are
held against the plain PyTorch version (parts bit for bit, rn within rtol
1e-6). Prints one JSON object per line and the card's ``nvidia-smi`` name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PEAK_HBM_BYTES = 3.35e12
TAPS = [(64, 64, 64), (32, 32, 128), (16, 16, 256), (8, 8, 512),
        (4, 4, 512)]  # (H, W, C) of the five taps at 64 px
SLOW_OPS = ("MUFU", "F2F", "F2I", "I2F", "FRND", "FCHK", "F2FP")
N_IMAGES = 2048  # one block of the attack
REPS = 10        # launches per timing


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def build(src: str, out_dir: str, name: str,
          extra: tuple = ()) -> tuple[str, str]:
    """nvcc ``src`` with the port's flags; returns (library, nvcc log)."""
    from ganleaks_tpu_torch.ops.cuda_build import NVCC_FLAGS, _nvcc
    lib = os.path.join(out_dir, f"lib{name}.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *extra, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def demangle(names: list[str]) -> list[str]:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names
    return [n.strip() for n in out] if len(out) == len(names) else names


def ptxas_report(log: str) -> dict:
    """Per kernel: registers and spill bytes from ``-Xptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return dict(zip(demangle(list(out)), out.values()))


def sass_counts(lib: str) -> dict:
    """Per kernel: instruction count, slow-pipe opcode counts, and
    ``chunk_code``: the instructions from the first FMUL (the channel sum
    of a chunk) to the last DFMA (its last element's rn term), the
    unrolled code of one 32-element chunk."""
    from torch.utils.cpp_extension import CUDA_HOME
    text = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib],
        capture_output=True, text=True, check=True).stdout
    out, name, ops, seq = {}, None, Counter(), []

    def close():
        fmul = [i for i, o in enumerate(seq) if o == "FMUL"]
        dfma = [i for i, o in enumerate(seq) if o.startswith("DFMA")]
        if fmul and dfma and dfma[-1] > fmul[0]:
            ops["chunk_code"] = dfma[-1] - fmul[0] + 1
        out[name] = ops

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                close()
            name, ops, seq = m.group(1), Counter(), []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        if m and name:
            ops["total"] += 1
            seq.append(m.group(1))
            base = m.group(1).split(".")[0]
            if base in SLOW_OPS:
                ops[m.group(1)] += 1
    if name:
        close()
    return dict(zip(demangle(list(out)), (dict(c) for c in out.values())))


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bench_tap_epilogue: no CUDA device", file=sys.stderr)
        return 1
    from ganleaks_tpu_torch.ops.cuda_build import CSRC_DIR
    from ganleaks_tpu_torch.ops.lpips.epilogue import (bind, launch_on,
                                                       tap_epilogue_plain)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another tap_epilogue .cu to build and time")
    ap.add_argument("--no-timing", action="store_true",
                    help="stop after the build reports")
    args = ap.parse_args()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    sources = dict(c.split("=", 1) for c in args.compare)
    sources["new"] = os.path.join(CSRC_DIR, "tap_epilogue.cu")
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, src in sources.items():
            path, log = build(src, tmp, name)
            emit({"library": name, "source": os.path.relpath(src, REPO),
                  "ptxas": ptxas_report(log), "sass": sass_counts(path)})
            libs[name] = bind(ctypes.CDLL(path))
        path, log = build(sources["new"], tmp, "new_fast_only",
                          ("-DTAP_EPILOGUE_FAST_ONLY",))
        emit({"library": "new_fast_only", "ptxas": ptxas_report(log),
              "sass": sass_counts(path)})
    if args.no_timing:
        print(smi, flush=True)
        return 0

    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(libs) + list(libs)[::-1]
    n = N_IMAGES
    for mode in ("bf16_int8", "f32"):
        dt = torch.bfloat16 if mode == "bf16_int8" else torch.float32
        out_dt = torch.int8 if mode == "bf16_int8" else torch.float32
        total = {name: 0.0 for name in libs}
        total_bytes = 0.0
        for i, (h, w, c) in enumerate(TAPS):
            fl = torch.randn((n, h, w, c), generator=gen,
                             device="cuda").relu_().to(dt)
            sc = torch.rand((c,), generator=gen, device="cuda") * 0.05
            bound = float(sc.max()) if out_dt == torch.int8 else None
            qscale = 127.0 / bound if bound is not None else 0.0
            kw = dict(embed_dtype=dt, out_dtype=out_dt, quant_bound=bound)
            want, rn_want = tap_epilogue_plain(fl, sc, **kw)
            outs = {}
            for name, lib in libs.items():
                out = torch.empty((n, h * w * c), dtype=out_dt, device="cuda")
                rn = torch.empty(n, device="cuda")
                err = launch_on(lib, fl, sc, dt, qscale, out, rn)
                torch.cuda.synchronize()
                if err != 0:
                    raise RuntimeError(f"{name}: launch failed ({err})")
                n_diff = int((out.view(n, h * w, c) != want).sum())
                rn_rel = float(((rn - rn_want).abs() / rn_want).max())
                if n_diff or rn_rel > 1e-6:
                    raise RuntimeError(f"{name} {mode} tap {i}: {n_diff} "
                                       f"parts differ, rn rel {rn_rel:.3g}")
                outs[name] = (out, rn)
            ms = {name: [] for name in libs}
            for name in order:
                out, rn = outs[name]
                ms[name].append(time_ms(torch, lambda: launch_on(
                    libs[name], fl, sc, dt, qscale, out, rn), REPS))
            nbytes = fl.numel() * (fl.element_size() + outs["new"][0]
                                   .element_size()) + n * 4 + c * 4
            bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
            row = {"mode": mode, "tap": i, "shape": [n, h, w, c],
                   "gb": nbytes / 1e9, "bound_ms": bound_ms}
            for name, t in ms.items():
                best = min(t)
                total[name] += best
                row[name] = {"ms": best, "ms_runs": t,
                             "gb_per_s": nbytes / (best * 1e-3) / 1e9,
                             "bound_share": bound_ms / best}
            total_bytes += nbytes
            emit(row)
            del fl, want, outs
        bound_ms = total_bytes / PEAK_HBM_BYTES * 1e3
        emit({"mode": mode, "summed_over_taps": True,
              "gb": total_bytes / 1e9, "bound_ms": bound_ms,
              **{name: {"ms": t, "gb_per_s": total_bytes / (t * 1e-3) / 1e9,
                        "bound_share": bound_ms / t}
                 for name, t in total.items()}})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
