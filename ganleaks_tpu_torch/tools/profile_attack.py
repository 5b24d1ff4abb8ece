"""Where the wall-clock of the fbb attack's search goes on the card (port
of the repository's ``tools/profile_attack.py``).

Times, at full width (VGG16 l2-lpips at ``--res`` px, K = 512,000 at
64 px, seeded surrogate backbone with the real lin heads):

* the featurise unit per block of ``--block`` images: the tower, the tap
  epilogue (K2) and the row norms into one (N, K) buffer
  (``ops/knn._fused_parts_norms``);
* one ``block x block`` fold tile of ``--engine``:
  'auto' (default) the attack's 'auto' on the card, taps-int8 parts on a
  bf16 tower folded by one int8 product per part
  (``_fold_block_parts_q``), the main path;
  'taps' bf16 parts on a bf16 tower folded by K1 on the wgmma tile (the
  JAX tool's recipe); 'pallas' float32 parts folded by K1 on the 3xTF32
  tile;
* the projected end-to-end time ``(n_q + n_syn) / images_per_s + n_q *
  n_syn / pairs_per_s`` beside one measured
  ``knn_argmin_streamed_parts`` call of the same recipe (after a warm-up
  call) and the gap;
* under the profiler (``utils/profiling.profile_to``), one more call of
  the search: the top device kernels by total time with their launches,
  the device's idle share of the call's window (both from the profiler's
  kernel intervals), the port's launch counters for the same call, and
  what the program's spans say (``utils/profiling.span_breakdown``): the
  device milliseconds each span launched and the card's idle milliseconds
  by the span the host was in.

CUDA events time every measurement after a warm-up call. Each prints one
JSON line with the card's name and power limit (``nvidia-smi``).

    python -m ganleaks_tpu_torch.tools.profile_attack
    python -m ganleaks_tpu_torch.tools.profile_attack --engine taps
    python -m ganleaks_tpu_torch.tools.profile_attack --device cpu \\
        --n_q 8 --n_syn 16 --block 8 --res 32

``--device`` defaults to cuda and refuses without a GPU; ``--device cpu``
runs the kernels' plain versions (no device metric: the kernel table is
empty and the idle share null).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from dataclasses import replace

import torch

from ganleaks_tpu_torch.attack.fbb import (build_embed_fn,
                                           resolve_auto_engine)
from ganleaks_tpu_torch.config import AttackConfig
from ganleaks_tpu_torch.device import card_line, resolve_device
from ganleaks_tpu_torch.ops.knn import (_fold_block_parts_q, _fold_fused,
                                        _fused_parts_norms,
                                        _part_bounds_for, _probe,
                                        _quant_factors,
                                        knn_argmin_streamed_parts)
from ganleaks_tpu_torch.ops.knn_fused import knn_argmin_fused
from ganleaks_tpu_torch.ops.lpips.epilogue import tap_epilogue
from ganleaks_tpu_torch.utils.profiling import (call_seconds,
                                                device_activity,
                                                kernel_table, profile_to,
                                                span_breakdown,
                                                stage_window, trace_stage)

ENGINES = ("auto", "taps", "pallas")
REPS = 3   # timed calls after the warm-up (the fold tile: twice as many)
TOP = 10   # device kernels printed
# the port's kernels as the profiler names them (substrings)
PORT_KERNELS = {"tap_epilogue": "tap_epilogue",
                "knn_argmin": "knn_partial_wgmma"}


def recipe(engine: str, res: int) -> AttackConfig:
    """The attack configuration ``engine`` stands for (module
    docstring)."""
    base = AttackConfig(distance="l2-lpips", resolution=res)
    if engine == "auto":  # what attack_arrays resolves 'auto' to on a card
        return resolve_auto_engine(replace(base, engine="auto"), "cuda")
    if engine == "taps":
        return replace(base, engine="taps", dtype="bfloat16",
                       lpips_compute_dtype="bfloat16")
    if engine == "pallas":
        return replace(base, engine="taps", dtype="float32")
    raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")


def _images(gen: torch.Generator, n: int, res: int,
            device: torch.device) -> torch.Tensor:
    return torch.randint(0, 256, (n, res, res, 3), generator=gen,
                         device=device, dtype=torch.uint8)


def profile(n_q: int = 2000, n_syn: int = 20000, block: int = 2048,
            res: int = 64, engine: str = "auto", device=None,
            trace_dir: str | None = None, emit=None) -> dict:
    """The measurements of the module docstring; each is passed to
    ``emit`` (default: printed as a JSON line) and returned under its
    ``measure`` name."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    head = {"tool": "profile_attack", "engine": engine,
            "device": torch.cuda.get_device_name(device) if cuda else "cpu",
            "card": card_line(device)}
    out: dict = {}

    def report(measure: str, **rec) -> None:
        rec = {**head, "measure": measure, **rec}
        out[measure] = rec
        (emit or (lambda r: print(json.dumps(r), flush=True)))(rec)

    cfg = recipe(engine, res)
    quantize = cfg.engine == "taps-int8"
    embed = build_embed_fn(cfg, device, structured=True)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.inference_mode():
        blk_q = _images(gen, block, res, device)
        blk_s = _images(gen, block, res, device)
        bounds = _part_bounds_for(embed, blk_q, device) if quantize else None
        cdtype = torch.int8 if quantize else _probe(embed, blk_q,
                                                    device)[0].dtype
        fused = _fused_parts_norms(embed, cdtype, bounds)
        t_feat = call_seconds(lambda: fused(blk_q), device, REPS)
        img_rate = block / t_feat
        report("featurize", block=block, res=res, ms=t_feat * 1e3,
               images_per_sec=img_rate, tower_dtype=cfg.lpips_compute_dtype
               or "float32", cache_dtype=str(cdtype).replace("torch.", ""))

        q, rq, widths = fused(blk_q)
        s, rs, _ = fused(blk_s)
        state = (torch.full((block,), torch.inf, device=device),
                 torch.zeros(block, dtype=torch.int32, device=device))
        if quantize:
            factors = _quant_factors(bounds)

            def fold():
                return _fold_block_parts_q(*state, q, rq, s, rs, 0, block,
                                           widths, factors)
        else:
            def fold():
                return _fold_fused(state, q, rq, s, rs, 0, block)
        t_fold = call_seconds(fold, device, 2 * REPS)
        k_dim = sum(widths)
        pair_rate = block * block / t_fold
        report("fold", block=block, k=k_dim, ms=t_fold * 1e3,
               pairs_per_sec=pair_rate,
               tops_per_sec=2 * block * block * k_dim / t_fold / 1e12)
        del q, rq, s, rs, blk_q, blk_s

        feat_s = (n_q + n_syn) / img_rate
        fold_s = n_q * n_syn / pair_rate
        queries = _images(gen, n_q, res, device)
        syn = _images(gen, n_syn, res, device)
        info: dict = {}

        def search():
            return knn_argmin_streamed_parts(
                embed, queries, syn, q_block=block, s_block=block,
                quantize=quantize, device=device, info=info)

        measured_s = call_seconds(search, device, reps=1)
        report("end_to_end", n_q=n_q, n_syn=n_syn,
               projected_s=feat_s + fold_s, projected_featurize_s=feat_s,
               projected_fold_s=fold_s, measured_s=measured_s,
               gap_s=measured_s - feat_s - fold_s,
               query_pairs_per_sec=n_q * n_syn / measured_s,
               plan={k: info[k] for k in ("q_block", "s_block", "sweeps")})

        with tempfile.TemporaryDirectory() as tmp:
            before = {"tap_epilogue": tap_epilogue.launches,
                      "knn_argmin": knn_argmin_fused.launches}
            with profile_to(trace_dir or tmp, device) as run:
                with trace_stage("profile_attack.search", device=device):
                    search()
            counted = {"tap_epilogue": tap_epilogue.launches,
                       "knn_argmin": knn_argmin_fused.launches}
            counted = {k: n - before[k] for k, n in counted.items()}
    lo, hi = stage_window(run.events, "profile_attack.search")
    activity = [a for a in device_activity(run.events)
                if a[2] > lo and a[1] < hi]
    table = kernel_table(activity)
    profiled = {k: sum(r["launches"] for r in table if sub in r["name"])
                for k, sub in PORT_KERNELS.items()}
    spans = span_breakdown(run.raw, "profile_attack.search")
    report("profile", window_ms=(hi - lo) / 1e3,
           device_busy_ms=sum(r["total_ms"] for r in table) if cuda
           else None,
           idle_share=1.0 - spans["busy_s"] / spans["window_s"] if cuda
           else None,
           kernels=table[:TOP], n_kernel_names=len(table),
           launches_profiled=profiled, launches_counted=counted,
           launched_ms_by_span=_ms(spans["launched"]),
           idle_ms_by_span=_ms(spans["idle"]) if cuda else None,
           trace=run.trace_path if trace_dir else None)
    return out


def _ms(table: dict[str, float]) -> dict[str, float]:
    """Seconds per name as milliseconds, largest first."""
    return {k: v * 1e3 for k, v in sorted(table.items(),
                                           key=lambda kv: -kv[1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_q", type=int, default=2000)
    ap.add_argument("--n_syn", type=int, default=20000)
    ap.add_argument("--block", type=int, default=2048)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--engine", default="auto", choices=ENGINES)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trace_dir", default=None,
                    help="keep the Chrome trace there (default: discarded)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    profile(args.n_q, args.n_syn, args.block, args.res, args.engine,
            args.device, args.trace_dir)
    print(json.dumps({"tool": "profile_attack", "measure": "seconds",
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
