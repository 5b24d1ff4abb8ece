"""Measure on the card what the stream planner (``ops/stream_plan``)
charges: the featuriser's peak bytes per row beyond its input and output
blocks, per LPIPS net, tower dtype, resolution and block size, and each
fold's temporaries per (query row x synthetic row) pair.

Usage (on a CUDA machine, from the repository root):

    python -m ganleaks_tpu_torch.tools.measure_stream_memory \\
        [--out stream_memory.jsonl]

Prints one JSON line per measurement, then one line with the table the
planner keeps (``ACT_BYTES_PER_ROW_64``: the largest per-row charge over
blocks, featurisers and resolutions, scaled to 64x64 and rounded up to
64 KiB; ``FOLD_BYTES_PER_PAIR``: the largest per-pair charge, rounded up
to a whole byte). Each number comes from ``torch.cuda.max_memory_allocated``
around one call, less what was allocated before it and what it returns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

NETS = (None, "vgg", "alex", "squeeze", "resnet")
TOWER_DTYPES = ("float32", "bfloat16")
# (resolution, blocks): the planner's blocks at 64 px, smaller ones where
# the rows are wider
SHAPES = ((32, (2048, 8192)), (64, (512, 2048, 8192)),
          (128, (256, 1024, 2048)))
FOLD_ROWS, FOLD_SBLOCK, FOLD_K = 4096, 2048, 4
KIB64 = 64 << 10


def peak_bytes(fn, device: torch.device) -> tuple[int, object]:
    """(peak bytes ``fn()`` allocated beyond what was allocated before it,
    its result), synchronised on the card."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    with torch.inference_mode():
        out = fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - base, out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def featurisers(net, tower_dtype: str, device: torch.device) -> dict:
    """name -> ``blk -> tensors`` for the flat featuriser and the parts
    featuriser into the tower dtype's cache and into int8 (the taps
    engines), as the attack builds them."""
    from ganleaks_tpu_torch.attack.fbb import build_embed_fn
    from ganleaks_tpu_torch.config import AttackConfig
    from ganleaks_tpu_torch.ops.knn import (_fused_parts_norms,
                                            _part_bounds_for, sq_norms)

    cfg = AttackConfig(distance="l2" if net is None else "l2-lpips",
                       lpips_net=net or "vgg", dtype=tower_dtype,
                       lpips_compute_dtype=None if tower_dtype == "float32"
                       else tower_dtype)
    flat = build_embed_fn(cfg, device)
    parts = build_embed_fn(cfg, device, structured=True)
    cdtype = getattr(torch, tower_dtype)

    def flat_norms(blk):
        e = flat(blk)
        return e, sq_norms(e)

    def parts_int8(blk):
        bounds = _part_bounds_for(parts, blk[:1].cpu().numpy())
        return _fused_parts_norms(parts, torch.int8, bounds)(blk)[:2]

    return {"flat": flat_norms,
            "parts": lambda blk: _fused_parts_norms(parts, cdtype)(blk)[:2],
            "parts_int8": parts_int8}


def measure_featurise(device: torch.device) -> list[dict]:
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for net in NETS:
        for tower_dtype in TOWER_DTYPES:
            if net is None and tower_dtype != "float32":
                continue
            fns = featurisers(net, tower_dtype, device)
            for res, blocks in SHAPES:
                for block in blocks:
                    x = torch.randint(0, 256, (block, res, res, 3),
                                      generator=gen, device=device,
                                      dtype=torch.uint8)
                    for name, fn in fns.items():
                        fn(x[:2])  # warm-up: cuDNN's plans, lazy handles
                        peak, out = peak_bytes(lambda: fn(x), device)
                        rec = {"what": "featurise", "net": net,
                               "tower_dtype": tower_dtype, "res": res,
                               "block": block, "featuriser": name,
                               "peak_bytes": peak,
                               "out_bytes": _nbytes(out),
                               "act_bytes_per_row": (peak - _nbytes(out))
                               / block}
                        del out
                        print(json.dumps(rec), flush=True)
                        rows.append(rec)
                    del x
                    torch.cuda.empty_cache()
    return rows


def measure_folds(device: torch.device) -> list[dict]:
    """Each fold kind once at FOLD_ROWS cached queries x FOLD_SBLOCK
    synthetic rows on VGG16's 64-px parts (K = 512,000)."""
    from ganleaks_tpu_torch.ops import knn
    from ganleaks_tpu_torch.ops.lpips.backbones import tap_shapes

    widths = (3 * 64 * 64,) + tuple(h * w * c for h, w, c
                                    in tap_shapes("vgg", (64, 64, 3)))
    k_dim = sum(widths)
    factors = (1e-6,) * len(widths)
    gen = torch.Generator(device=device).manual_seed(1)
    rq = torch.rand(FOLD_ROWS, generator=gen, device=device)
    rs = torch.rand(FOLD_SBLOCK, generator=gen, device=device)
    n, sb, k = FOLD_ROWS, FOLD_SBLOCK, FOLD_K

    def argmin_state():
        return (torch.full((n,), torch.inf, device=device),
                torch.zeros(n, dtype=torch.int32, device=device))

    def topk_state():
        return (torch.full((n, k), torch.inf, device=device),
                torch.full((n, k), -1, dtype=torch.int32, device=device))

    def rand(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen,
                                 device=device, dtype=torch.int8)
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    out = []
    for kind, dtype in (("fused", torch.bfloat16), ("gemm", torch.float32),
                        ("int8", torch.int8),
                        ("topk_fused", torch.bfloat16),
                        ("topk_gemm", torch.float32),
                        ("topk_int8", torch.int8)):
        q, s = rand((n, k_dim), dtype), rand((sb, k_dim), dtype)
        st = topk_state() if kind.startswith("topk") else argmin_state()
        folds = {
            "fused": lambda: knn._fold_fused(st, q, rq, s, rs, 0, sb),
            "gemm": lambda: knn._fold_block(*st, q, rq, s, 0, sb, "gemm",
                                            rs),
            "int8": lambda: knn._fold_block_parts_q(
                *st, q, rq, s, rs, 0, sb, widths, factors),
            "topk_fused": lambda: knn._fold_fused_topk(
                *st, q, rq, s, rs, 0, sb, k),
            "topk_gemm": lambda: knn._fold_block_topk(
                *st, q, rq, s, 0, sb, k, "gemm", rs),
            "topk_int8": lambda: knn._fold_block_topk_parts_q(
                *st, q, rq, s, rs, 0, sb, k, widths, factors)}
        folds[kind]()  # warm-up: kernel build, cuBLAS handles
        peak, res = peak_bytes(folds[kind], device)
        rec = {"what": "fold", "kind": kind, "rows": n, "s_block": sb,
               "k_dim": k_dim, "peak_bytes": peak,
               "state_bytes": _nbytes(res),
               "bytes_per_pair": (peak - _nbytes(res)) / (n * sb)}
        print(json.dumps(rec), flush=True)
        out.append(rec)
        del q, s, st, res
        torch.cuda.empty_cache()
    return out


def table(feat: list[dict], folds: list[dict]) -> dict:
    """The planner's constants from the measurements (module docstring)."""
    act: dict = {}
    for r in feat:
        key = (r["net"], r["tower_dtype"])
        per64 = r["act_bytes_per_row"] * (64 * 64) / (r["res"] * r["res"])
        act[key] = max(act.get(key, 0.0), per64)
    act_table = {f"{k[0]},{k[1]}": int(-(-v // KIB64) * KIB64)
                 for k, v in act.items()}
    fold_table = {r["kind"]: int(-(-max(0.0, r["bytes_per_pair"]) // 1))
                  for r in folds}
    return {"ACT_BYTES_PER_ROW_64": act_table,
            "FOLD_BYTES_PER_PAIR": fold_table}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_stream_memory: no CUDA device", file=sys.stderr)
        return 1
    from ganleaks_tpu_torch.device import set_f32_numerics
    set_f32_numerics()
    device = torch.device("cuda")
    feat = measure_featurise(device)
    folds = measure_folds(device)
    summary = {"card": torch.cuda.get_device_name(0),
               "torch": torch.__version__, **table(feat, folds)}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            for rec in feat + folds + [summary]:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
