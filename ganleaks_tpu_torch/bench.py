"""Headline benchmark of the port: the fbb l2-lpips attack's query-pairs/s
end to end on one CUDA GPU (the port of root ``bench.py --metric knn``).

    python -m ganleaks_tpu_torch.bench             # the north star
    python -m ganleaks_tpu_torch.bench --quick     # a small smoke size
    python -m ganleaks_tpu_torch.bench --n_q 2000 --n_syn 20000
    python -m ganleaks_tpu_torch.bench --engine taps --two_pass

Prints ONE JSON line on standard output,
``{"metric", "value", "unit", "vs_baseline"}``: query pairs (N_q x N_syn)
over the seconds of one ``attack.fbb.attack_arrays`` call, from the
featurisers' build to the device-to-host copy of its results, after one
warm-up call on the same sets. ``vs_baseline`` is over the reference's
torch-CPU rate (``BASELINE.md``). A JSON line on standard error gives the
call's featurise / fold / set-up seconds, its plan and OOM resumes, and
the peak device memory.

The default is the north star: 20,000 queries (10,000 + 10,000) x
100,000 synthetic images at 64x64, uint8 storage, engine taps-int8 on a
bf16 tower, the seeded surrogate VGG16 with the real v0.1 lin heads, and
the device-memory planner on. The sets are drawn from ``--seed`` with
numpy. Without a GPU it refuses; ``main(argv, device="cpu")`` runs on the
CPU. A failed engine or an unrecovered out-of-memory error exits non-zero:
nothing falls back.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# the reference's torch-CPU rate: LPIPS VGG16 + L2 over 64-image batches
# on one core (BASELINE.md, "measured baseline")
REFERENCE_CPU_PAIRS_PER_SEC = 15.0
RESOLUTION = 64


def resolve_defaults(*, quick: bool, n_q, n_syn, q_block, s_block,
                     cache_gb, store, two_pass: bool, dtype: str):
    """The CLI's None defaults as a concrete run: the north star with no
    ``--quick`` and no explicit size, small sizes with ``--quick``, and the
    2,000 x 20,000 shape for the size not given when one is. Returns
    ``(n_q, n_syn, q_block, s_block, cache_gb, store)``, equal to root
    ``bench.py``'s for the same arguments. Pure."""
    north_star = not quick and n_q is None and n_syn is None
    if quick:
        dq, ds, dqb, dsb = 64, 512, 64, 256
    elif north_star:
        dq, ds, dqb, dsb = 20000, 100000, 2048, 2048
    else:
        dq, ds, dqb, dsb = 2000, 20000, 2048, 2048
    n_q, n_syn = n_q or dq, n_syn or ds
    q_block, s_block = q_block or dqb, s_block or dsb
    if cache_gb is None:
        cache_gb = 10.0 if north_star else 8.0
    if north_star and store is None and not two_pass \
            and dtype == "bfloat16":
        store = "uint8"
    return n_q, n_syn, q_block, s_block, cache_gb, store


def make_sets(n_q: int, n_syn: int, store: str | None, seed: int):
    """(queries, synthetic) NHWC sets from ``seed``: uint8 bytes for
    ``store='uint8'``, else float32 in [-1, 1] (numpy has no bfloat16; a
    bf16 tower casts its input)."""
    rng = np.random.default_rng(seed)
    shape = (RESOLUTION, RESOLUTION, 3)
    if store == "uint8":
        return (rng.integers(0, 256, (n_q,) + shape, dtype=np.uint8),
                rng.integers(0, 256, (n_syn,) + shape, dtype=np.uint8))
    return (rng.uniform(-1, 1, (n_q,) + shape).astype(np.float32),
            rng.uniform(-1, 1, (n_syn,) + shape).astype(np.float32))


def run_bench(cfg, queries: np.ndarray, syn: np.ndarray,
              device: torch.device) -> dict:
    """One warm-up ``attack_arrays`` call, then the timed one."""
    from ganleaks_tpu_torch.attack.fbb import attack_arrays

    half = len(queries) // 2
    pos, neg = queries[:half], queries[half:]
    attack_arrays(cfg, syn, pos, neg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = attack_arrays(cfg, syn, pos, neg, device=device)
    seconds = time.perf_counter() - t0  # its results are on the host
    out["seconds"] = seconds
    out["peak_mem_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                          if device.type == "cuda" else None)
    return out


def main(argv=None, device=None) -> int:
    from ganleaks_tpu_torch.config import AttackConfig
    from ganleaks_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--engine", default="taps-int8",
                    choices=["gemm", "pallas", "exact", "taps", "taps-int8"])
    ap.add_argument("--two_pass", action="store_true",
                    help="bf16 candidate pass + float32 re-rank under the "
                         "exactness certificate")
    ap.add_argument("--two_pass_k", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16",
                    help="embedding dtype ('float32' for the parity tower)")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    help="tower dtype; 'float32' for parity")
    ap.add_argument("--n_q", type=int, default=None)
    ap.add_argument("--n_syn", type=int, default=None)
    ap.add_argument("--q_block", type=int, default=None)
    ap.add_argument("--s_block", type=int, default=None)
    ap.add_argument("--store", default=None,
                    choices=["uint8", "bfloat16", "float32"],
                    help="image storage; the north star's default is uint8")
    ap.add_argument("--cache_gb", type=float, default=None,
                    help="requested query-cache GiB (default 10 at the "
                         "north star, else 8); the planner may change it")
    ap.add_argument("--no_auto_plan", action="store_true",
                    help="keep --cache_gb and the blocks exactly as given")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(device)

    n_q, n_syn, q_block, s_block, cache_gb, store = resolve_defaults(
        quick=args.quick, n_q=args.n_q, n_syn=args.n_syn,
        q_block=args.q_block, s_block=args.s_block, cache_gb=args.cache_gb,
        store=args.store, two_pass=args.two_pass, dtype=args.dtype)
    compute = None if args.compute_dtype == "float32" else args.compute_dtype
    cfg = AttackConfig(
        resolution=RESOLUTION, distance="l2-lpips", lpips_net="vgg",
        engine=args.engine, dtype=args.dtype, lpips_compute_dtype=compute,
        two_pass=args.two_pass, two_pass_k=args.two_pass_k,
        query_block=q_block, syn_block=s_block, query_cache_gb=cache_gb,
        auto_plan=not args.no_auto_plan, uint8_storage=store == "uint8",
        save_plots=False)
    t0 = time.perf_counter()
    queries, syn = make_sets(n_q, n_syn, store, args.seed)
    data_s = time.perf_counter() - t0
    out = run_bench(cfg, queries, syn, device)

    value = n_q * n_syn / out["seconds"]
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    mode = f"{args.engine}+two-pass" if args.two_pass else args.engine
    print(json.dumps({
        "detail": {k: out.get(k) for k in (
            "seconds", "featurize_s", "fold_s", "lpips_init_s",
            "host_copy_s", "sets_on_device", "oom_resumes", "plan",
            "two_pass_fallbacks", "peak_mem_gb")}, "data_s": data_s}),
        file=sys.stderr)
    print(json.dumps({
        "metric": f"fbb LPIPS kNN query-pairs/sec ({card}, {mode}, "
                  f"{n_q}x{n_syn} @{RESOLUTION}x{RESOLUTION})",
        "value": round(value, 1),
        "unit": "query-pairs/sec",
        "vs_baseline": round(value / REFERENCE_CPU_PAIRS_PER_SEC, 1)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
