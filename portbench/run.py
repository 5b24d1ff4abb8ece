"""Run one cell of the port's benchmark once and print its result.

    python3 -m portbench.run --workload vgg16-64.grid --seed 7 \\
        --seconds 30 --trace 0

The cell is ``workloads/<name>.json`` (its configuration, traffic, warm-up
and comparison), its configuration ``configs/<config>.json``, the
configuration's module ``modules/<module>.py`` (``modules/lpips.py``
where the configuration names none), and its metrics the entries of the
checkout's ``BENCHMARK.json`` that apply to it, each read by
``metrics/<metric>.py``. A run:

1. set-up: the module's ``Bench`` (weights and inputs from the seed, the
   files the program reads under ``TMPDIR``), then warm-up calls at the
   cell's shape (the default module's also fill the program's query
   cache, the ``sweep_cache`` a grid study passes every victim);
2. the window: a closed loop of one caller, each call the module's
   ``timed_call`` on an input no earlier call saw, made from (seed, call)
   before the call's clock starts; it closes once the calls' seconds
   reach ``--seconds``;
3. ``--trace 1``: the window runs under ``torch.profiler`` and the
   result carries the per-layer metrics, the device's busy seconds and a
   breakdown; ``--trace 0`` takes no profiler and reports the end-to-end
   metrics;
4. the comparison with the module's plain reference (``check.py``) once
   the program's state is freed.

The last line of standard output is the result, as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error. Without a CUDA card (or with fewer than the cell asks for), or
with JAX or the JAX package loaded once the window has closed, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

# One thread for the CPU operators of numpy and torch, set before either
# loads. Each call is bound by the caller's one thread; idle pool workers
# spinning beside it on a shared host's cores slowed it at random, by a
# tenth and more.
HOST_THREADS = 1
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(HOST_THREADS)

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "ganleaks_tpu")
MAX_FAILED = 3  # calls that may raise before the window closes early
DEFAULT_MODULE = "lpips"


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str, root: str) -> tuple[dict, dict, dict]:
    """(BENCHMARK.json, the workload file, its configuration file)."""
    bench = load_json(root, "BENCHMARK.json")
    here = os.path.join(root, "portbench")
    workload = load_json(here, "workloads", f"{name}.json")
    config = load_json(here, "configs", f"{workload['config']}.json")
    return bench, workload, config


def cell_metrics(bench: dict, cell: str, kind: str) -> list[tuple[str, str]]:
    """(name, unit) of the ``kind`` metrics ('end_to_end' or 'per_layer')
    that ``cell`` reports."""
    return [(m["name"], m["unit"]) for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def _load(root: str, folder: str, name: str):
    """``portbench/<folder>/<name>.py``, loaded by its path."""
    path = os.path.join(root, "portbench", folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str):
    """The ``read(records)`` function of ``metrics/<name>.py``."""
    return _load(root, "metrics", name).read


def config_module(config: dict, root: str):
    """The configuration's module: ``modules/<config["module"]>.py``, or
    ``modules/lpips.py`` where the configuration names none."""
    return _load(root, "modules", config.get("module", DEFAULT_MODULE))


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package
    (compared whole: ``ganleaks_tpu_torch`` is not ``ganleaks_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def refused(bad: list[str]) -> bool:
    """Name on standard error the forbidden modules found, if any."""
    if bad:
        print(f"portbench: loaded in the process that measured: "
              f"{', '.join(bad)}", file=sys.stderr)
    return bool(bad)


class _Records:
    """The logger handed to the program: keeps the records it logs."""

    def __init__(self):
        self.records: list[dict] = []

    def log(self, record: dict, step=None) -> None:
        self.records.append(dict(record))


def device_line(torch, device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": peak}


def card_power(device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card."""
    if device.type != "cuda":
        return None
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0]


def run_cell(args, workload: dict, config: dict, module, device) -> dict:
    """Set-up, the window and the comparison; returns what the metrics
    and the result line read."""
    import torch

    from portbench import check, trace, traffic

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    tmp = tempfile.TemporaryDirectory(prefix="portbench-")
    bench = module.Bench(config, workload, args.seed, device, tmp.name)
    log = _Records()

    for i in range(workload["warmup_calls"]):
        inp, _ = bench.call_input(i, traffic.WARMUP)
        bench.timed_call(inp, log)
        del inp
    sync()

    calls, results, sums = [], [], []
    setup_s = None
    peak = 0
    with trace.profiled(bool(args.trace)) as prof:
        window = 0.0
        t_window = time.perf_counter()
        while window < args.seconds:
            inp, total = bench.call_input(len(calls), traffic.WINDOW)
            sums.append(total)
            if cuda:
                sync()
                torch.cuda.reset_peak_memory_stats(device)
            log.records.clear()
            if setup_s is None:
                setup_s = time.perf_counter() - T_START
            t0 = time.perf_counter()
            try:
                with trace.call_range(prof):
                    out = bench.timed_call(inp, log)
            except Exception:  # a failed call is counted, not fatal
                traceback.print_exc()
                out = None
            dt = time.perf_counter() - t0
            window += dt
            if cuda:
                peak = max(peak, torch.cuda.max_memory_allocated(device))
            rec = {"seconds": dt, "ok": out is not None,
                   **bench.record(inp, out, log.records)}
            if out is not None and "counters" in out:
                rec["counters"] = dict(out["counters"])
            results.append(None if out is None else bench.answers(out))
            calls.append(rec)
            del inp, out
            if sum(not c["ok"] for c in calls) >= MAX_FAILED:
                break
            if time.perf_counter() - t_window > 3 * args.seconds + 60:
                break
        sync()
    bad_modules = loaded_forbidden()

    t_closed = time.perf_counter()
    # the program's state goes before the reference runs
    bench.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    traced = trace.reduce(prof) if prof is not None else None
    del prof
    t_traced = time.perf_counter()

    # the comparison, on calls and queries drawn from the seed
    cspec = workload["check"]
    numbers = check.judge(bench, args.seed, calls, results, sums, cspec)
    correct, table = check.verdict(numbers, cspec["limits"])
    del bench
    tmp.cleanup()
    print(f"window_wall_s {t_closed - t_window!r} trace_reduce_s "
          f"{t_traced - t_closed!r} check_s "
          f"{time.perf_counter() - t_traced!r}", file=sys.stderr)
    return {"calls": calls, "setup_s": setup_s, "trace": traced,
            "memory_peak_bytes": int(peak), "correct": correct,
            "check": table, "bad_modules": bad_modules}


def main(argv=None, device=None, root: str | None = None) -> int:
    """Run a cell; ``device`` None asks for the card the cell needs
    (tests pass 'cpu'), ``root`` is the checkout (default: this one)."""
    args = parse(argv)
    root = root or os.path.dirname(HERE)
    bench, workload, config = load_cell(args.workload, root)
    import torch

    from portbench import trace

    torch.set_num_threads(HOST_THREADS)  # where torch loaded before this

    chips = workload["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA card(s); "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        device = "cuda"
    device = torch.device(device)
    kind = "per_layer" if args.trace else "end_to_end"
    wanted = cell_metrics(bench, args.workload, kind)
    module = config_module(config, root)
    got = run_cell(args, workload, config, module, device)
    if refused(got["bad_modules"]):
        return 3
    dev = device_line(torch, device, chips, got["memory_peak_bytes"])
    records = {"cell": workload, "config": config, "module": module,
               "calls": got["calls"], "setup_s": got["setup_s"],
               "trace": got["trace"], "device_kind": dev["kind"]}
    metrics = {}
    for name, unit in wanted:
        value = reader(name, root)(records)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    result = {"correct": got["correct"], "attempted": len(got["calls"]),
              "failed": sum(not c["ok"] for c in got["calls"]),
              "metrics": metrics, "device": dev}
    if got["trace"] is not None:
        t = got["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = {"device_ops": trace.top(t["ops"]),
                               "idle_gaps": trace.top(t["idle"])}
    result["card"] = card_power(device)
    result["check"] = got["check"]
    secs = [c["seconds"] for c in got["calls"]]
    print(f"call_seconds {json.dumps(secs)}", file=sys.stderr)
    print(f"calls {len(secs)} first_s {secs[0]!r} median_s "
          f"{float(np.median(secs))!r} max_s {max(secs)!r}", file=sys.stderr)
    print(f"oom_resumes {sum(c.get('oom_resumes', 0) for c in got['calls'])}",
          file=sys.stderr)
    # the reference, the trace's reduction and the readers ran since the
    # window closed: what they loaded is looked for again
    if refused(loaded_forbidden()):
        return 3
    for name, row in got["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
