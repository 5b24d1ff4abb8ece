#!/usr/bin/env python3
"""Drive the PyTorch port (``ganleaks_tpu_torch``) on one CUDA GPU and check
it. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions, and the build of every kernel library from ``csrc/``;
2. kernel: the fused distance+argmin kernel against its plain PyTorch
   version on the card, in float32 and bfloat16 — a ragged synthetic count,
   one smaller than a tile, several tiles per block, K not a multiple of 4,
   the attack's K = 512,000, and planted duplicate rows (exact ties);
3. attack: the full-width fbb l2-lpips attack (VGG16 at 64x64x3,
   K = 512,000, seeded surrogate backbone with the real lin heads) through
   ``run_attack(engine='pallas')`` and ``evaluate`` on 1,024 members, 1,024
   non-members and 8,192 synthetic images written as npz, with members'
   noisy copies planted in the synthetic set; then the same arrays through
   ``engine='gemm'`` (the ``torch.matmul`` fold) as the cross-check;
4. timing: the kernel, held once more against its plain version, then
   timed with the plain version and one library composition
   (``torch.addmm`` + ``torch.min``, timed only) at the attack's block shape
   (2,048 x 2,048, K = 512,000, float32), beside the card's bound.

Then, on lines of their own, the ``nvidia-smi`` name/power line and the
``{"kernels": [...]}`` summary, and last ``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero and prints no result.
Without a CUDA device, or without the package beside it, it exits 1 before
printing anything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet (dense, 700 W): float32 on the CUDA cores and
# device-memory bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# |d_kernel - d_plain| <= TOL * (rq + rs): the two sum K products in
# different orders and rq + rs - 2 q.s cancels
TOL = 1e-5
SEED = 0
# the main path's shapes; a rehearsal on the CPU may shrink them
DEVICE = "cuda"
N_POS = 1024
N_SYN = 8192
RES = 64


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_inputs(torch, n_q, n_s, k_dim, dtype, ties, gen):
    """Seeded q (n_q, K), s (n_s, K) and their float32 squared norms.
    ``ties``: (query row, a, b) with s[a] == s[b] planted as that query's
    nearest rows, a < b."""
    from ganleaks_tpu_torch.ops.knn_fused import sq_norms
    dev = torch.device(DEVICE)
    q = torch.randn((n_q, k_dim), generator=gen, device=dev) / k_dim ** 0.5
    s = torch.randn((n_s, k_dim), generator=gen, device=dev) / k_dim ** 0.5
    for row, a, b in ties:
        near = q[row] + 0.05 * torch.randn(
            (k_dim,), generator=gen, device=dev) / k_dim ** 0.5
        s[a] = near
        s[b] = near
    q, s = q.to(dtype).contiguous(), s.to(dtype).contiguous()
    return q, s, sq_norms(q), sq_norms(s)


def kernel_case(torch, name, n_q, n_s, k_dim, dtype, ties, gen):
    """One comparison on the card at freshly made inputs."""
    q, s, rq, rs = kernel_inputs(torch, n_q, n_s, k_dim, dtype, ties, gen)
    return hold_against_plain(torch, name, q, s, rq, rs, ties)


def hold_against_plain(torch, name, q, s, rq, rs, ties):
    """The kernel against its plain version on the same inputs: every d
    within TOL * (rq + rs), indices equal wherever the plain version's best
    two distances lie further apart than that, and on the planted ties."""
    from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                                  knn_argmin_plain)
    n_q, k_dim = q.shape
    n_s = s.shape[0]
    d_k, i_k = knn_argmin_fused(q, s, rq=rq, rs=rs)
    d_p, i_p = knn_argmin_plain(q, s, rq, rs)
    if DEVICE == "cuda":
        torch.cuda.synchronize()  # a fault in the kernel surfaces here
    full = rq[:, None] + rs[None, :] - 2.0 * (q.float() @ s.float().T)
    tol = TOL * (rq + rs[i_p.long()])
    err = (d_k - d_p).abs()
    check(bool(torch.isfinite(d_k).all()), f"{name}: non-finite d")
    check(bool((err <= tol).all()),
          f"{name}: d off by {float((err / tol).max()):.3g} x tolerance")
    if n_s >= 2:
        top2 = torch.topk(full, 2, dim=1, largest=False).values
        clear = (top2[:, 1] - top2[:, 0]) > tol
    else:
        clear = torch.ones_like(err, dtype=torch.bool)
    bad = clear & (i_k != i_p)
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} indices differ where the plain "
          f"version's best two are apart")
    for row, a, _b in ties:
        check(int(i_p[row]) == a and int(i_k[row]) == a,
              f"{name}: planted tie at query {row} -> kernel "
              f"{int(i_k[row])}, plain {int(i_p[row])}, want {a}")
    return {"case": name, "n_q": n_q, "n_s": n_s, "k": k_dim,
            "dtype": str(q.dtype).replace("torch.", ""),
            "max_abs_err": float(err.max()),
            "max_err_over_tol": float((err / tol).max()),
            "ambiguous_rows": int((~clear).sum()),
            "ties": len(ties)}


def phase_kernel(torch) -> float:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    cases = [
        # ragged n_s (7 tiles + 104 rows), ties across tiles and spans
        ("ragged", 200, 1000, 1000, [(3, 10, 900), (150, 129, 130)]),
        # n_s below one tile, K not a multiple of 4 (scalar loads)
        ("small_s_odd_k", 130, 50, 4099, [(7, 5, 40)]),
        # many tiles per block, the merge across spans
        ("long_s", 100, 70000, 64, [(50, 3, 69999)]),
        # the attack's embedding width
        ("k512000", 256, 300, 512000, [(0, 1, 299), (255, 128, 256)]),
    ]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, n_q, n_s, k_dim, ties in cases:
            res = kernel_case(torch, name, n_q, n_s, k_dim, dtype, ties, gen)
            if dtype == torch.float32:
                worst = max(worst, res["max_abs_err"])
            emit({"phase": "kernel", **res})
    return worst


# ---------------------------------------------------------------------------
# phase 3: the attack at full width
# ---------------------------------------------------------------------------

def make_images(rng, n: int, res: int = 64) -> np.ndarray:
    """Image-like uint8 NHWC: an 8x8 random layout upsampled, plus
    pixel noise."""
    base = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.int16)
    up = np.repeat(np.repeat(base, res // 8, axis=1), res // 8, axis=2)
    noise = rng.integers(-24, 25, up.shape, dtype=np.int16)
    return np.clip(up + noise, 0, 255).astype(np.uint8)


def pair_distances(torch, embed, queries, syn, idx, device,
                   chunk: int = 256):
    """float64 ||phi(q_i) - phi(syn[idx_i])||^2 and rq + rs per row, from
    float32 embeddings, in chunks of ``chunk`` rows."""
    d, norms = [], []
    with torch.inference_mode():
        for lo in range(0, len(queries), chunk):
            eq = embed(torch.from_numpy(queries[lo:lo + chunk])
                       .to(device)).double()
            es = embed(torch.from_numpy(syn[idx[lo:lo + chunk]])
                       .to(device)).double()
            d.append(((eq - es) ** 2).sum(1).cpu().numpy())
            norms.append(((eq ** 2).sum(1) + (es ** 2).sum(1)).cpu().numpy())
    return np.concatenate(d), np.concatenate(norms)


def phase_attack(torch, tmp: str) -> dict:
    from ganleaks_tpu_torch.attack.eval_roc import evaluate
    from ganleaks_tpu_torch.attack.fbb import build_embed_fn, run_attack
    from ganleaks_tpu_torch.config import AttackConfig, EvalConfig
    from ganleaks_tpu_torch.ops.knn_fused import knn_argmin_fused

    n_pos = n_neg = N_POS
    n_syn = N_SYN
    k_dim = 125 * RES * RES  # pixel part 3 R^2 + five VGG16 taps 122 R^2
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    pos = make_images(rng, n_pos, RES)
    neg = make_images(rng, n_neg, RES)
    syn = make_images(rng, n_syn, RES)
    slots = rng.permutation(n_syn)[:n_pos]  # members' noisy copies
    syn[slots] = np.clip(pos.astype(np.int16)
                         + rng.integers(-8, 9, pos.shape, dtype=np.int16),
                         0, 255).astype(np.uint8)
    paths = {}
    for name, arr in (("pos", pos), ("neg", neg), ("syn", syn)):
        paths[name] = os.path.join(tmp, f"{name}.npz")
        np.savez(paths[name], images=arr)
    data_s = time.perf_counter() - t0

    base = dict(syn_data_path=paths["syn"], pos_data_dir=paths["pos"],
                neg_data_dir=paths["neg"], resolution=RES,
                distance="l2-lpips", dtype="float32", query_block=2048,
                syn_block=2048, save_plots=False,
                save_root=os.path.join(tmp, "runs"))
    runs = {}
    for engine in ("pallas", "gemm"):
        cfg = AttackConfig(exp_name=f"smoke_{engine}", engine=engine, **base)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        knn_argmin_fused.launches = 0
        t0 = time.perf_counter()
        out = run_attack(cfg, DEVICE)[0]
        e2e = time.perf_counter() - t0
        launches = knn_argmin_fused.launches
        ev = evaluate(EvalConfig(result_load_dir=out["save_dir"]))
        runs[engine] = {"out": out, "auc": ev["auc"], "launches": launches,
                        "e2e_s": e2e,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
                        if DEVICE == "cuda" else None}
        emit({"phase": "attack", "engine": engine, "n_pos": n_pos,
              "n_neg": n_neg, "n_syn": n_syn, "k": k_dim,
              "auroc": ev["auc"], "ap": ev["ap"],
              "kernel_launches": launches,
              "featurize_s": out["featurize_s"], "fold_s": out["fold_s"],
              "end_to_end_s": e2e,
              "query_pairs_per_sec": out["query_pairs_per_sec"],
              "peak_mem_gb": runs[engine]["peak_mem_gb"],
              "data_gen_s": data_s})

    p, g = runs["pallas"], runs["gemm"]
    check(p["launches"] > 0, "the pallas engine never launched the kernel")
    check(g["launches"] == 0, "the gemm engine launched the kernel")
    for key in ("pos_loss", "neg_loss"):
        check(p["out"][key].shape == (n_pos,)
              and bool(np.isfinite(p["out"][key]).all()),
              f"{key}: not {n_pos} finite values")
    check(p["auc"] > 0.9, f"AUROC {p['auc']:.4f} <= 0.9 with planted "
                          f"member copies")
    check(abs(p["auc"] - g["auc"]) <= 1e-6,
          f"AUROC pallas {p['auc']} vs gemm {g['auc']}")

    # every loss against the float64 distance of the pair its engine chose
    # (same float32 embeddings). The kernel's must lie within TOL * (rq +
    # rs). The gemm fold's error is cuBLAS's float32 sum over K and is only
    # reported: it is the cross-check, not the kernel under test.
    queries = np.concatenate([pos, neg])
    embed = build_embed_fn(
        AttackConfig(distance="l2-lpips", dtype="float32"), DEVICE)
    ref = {}
    for engine, r in runs.items():
        idx = np.concatenate([r["out"]["pos_nn_idx"],
                              r["out"]["neg_nn_idx"]])
        loss = np.concatenate([r["out"]["pos_loss"], r["out"]["neg_loss"]])
        d64, norms = pair_distances(torch, embed, queries, syn, idx, DEVICE)
        ref[engine] = (idx, d64, norms, float((np.abs(loss - d64)
                                                / norms).max()))
    (i_p, d_p, n_p, e_p), (i_g, d_g, _, e_g) = ref["pallas"], ref["gemm"]
    check(e_p <= TOL, f"pallas: losses off their float64 distances by "
                      f"{e_p:.3g} x (rq + rs)")
    # an engine whose distances are off by at most e * (rq + rs) can only
    # pick a row whose float64 distance lies within 2 e * (rq + rs) of the
    # best, so two engines may disagree only between such near-ties
    mm = i_p != i_g
    near = 2.0 * max(TOL, e_p, e_g)
    check(bool((np.abs(d_p - d_g)[mm] <= near * n_p[mm]).all()),
          f"{int(mm.sum())} index mismatches, not all within "
          f"{near:.3g} x (rq + rs) of each other")
    emit({"phase": "attack_check", "index_mismatches": int(mm.sum()),
          "loss_err_over_norms": {"pallas": e_p, "gemm": e_g},
          "auroc_pallas": p["auc"], "auroc_gemm": g["auc"]})
    return {"launches": p["launches"]}


# ---------------------------------------------------------------------------
# phase 4: timing at the attack's block shape
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps: int = 3) -> float:
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


def phase_timing(torch) -> dict:
    from ganleaks_tpu_torch.ops.knn_fused import (knn_argmin_fused,
                                                  knn_argmin_plain)
    n_q = n_s = 2048
    k_dim = 512000
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    # no planted near-copy here: its q.s sums 512,000 products >= 0, and at
    # this shape cuBLAS keeps one running float32 sum per output, which
    # drifts past TOL (phase 3 measures that against float64); phase 2
    # holds the ties at K = 512,000, a shape where the plain version stays
    # within TOL
    q, s, rq, rs = kernel_inputs(torch, n_q, n_s, k_dim, torch.float32, [],
                                 gen)
    held = hold_against_plain(torch, "main_block", q, s, rq, rs, [])
    emit({"phase": "kernel", **held})

    def library():
        return torch.min(torch.addmm(rs[None, :], q, s.T, alpha=-2.0)
                         + rq[:, None], dim=1)

    max_err = held["max_abs_err"]
    ms = time_ms(torch, lambda: knn_argmin_fused(q, s, rq=rq, rs=rs))
    plain_ms = time_ms(torch, lambda: knn_argmin_plain(q, s, rq, rs))
    library_ms = time_ms(torch, library)
    ms2 = time_ms(torch, lambda: knn_argmin_fused(q, s, rq=rq, rs=rs))
    flops = 2.0 * n_q * n_s * k_dim
    nbytes = (n_q + n_s) * k_dim * 4 + (n_q + n_s) * 4 + n_q * 8
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    res = {"n_q": n_q, "n_s": n_s, "k": k_dim, "dtype": "float32",
           "ms": min(ms, ms2), "ms_runs": [ms, ms2], "plain_ms": plain_ms,
           "library_ms": library_ms, "max_abs_err": max_err,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "tflops": flops / (min(ms, ms2) * 1e-3) / 1e12}
    emit({"phase": "timing", **res})
    return res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        from ganleaks_tpu_torch.device import set_f32_numerics
        from ganleaks_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the ganleaks_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 1
    set_f32_numerics()

    smi = nvidia_smi_line()
    build_s = cuda_build.build_all()
    log = cuda_build.build_log("knn_argmin")
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    kernel_err = phase_kernel(torch)
    with tempfile.TemporaryDirectory() as tmp:
        attack = phase_attack(torch, tmp)
    timing = phase_timing(torch)

    print(smi, flush=True)
    emit({"kernels": [{
        "name": "knn_argmin",
        "route": "cuda",
        "source": "ganleaks_tpu_torch/csrc/knn_argmin.cu",
        "replaces": "ganleaks_tpu/ops/knn_pallas.py:269",
        "launches": attack["launches"],
        "max_abs_err": max(kernel_err, timing["max_abs_err"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
