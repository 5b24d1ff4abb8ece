"""The control of a cell's comparison: the configuration module's plain
reference put in the program's place one precision step below the
configuration's (the default module's int8 parts become int4: 7 steps of
the same static bounds), read by the same numbers as a run's ``check``.
The limits must fail it.

    python3 -m portbench.control --workload vgg16-64.grid --seeds 1 2 3

For each seed: the module's set-up and the inputs of as many calls as a
run compares, made as a run makes them (``Bench.control``); one JSON
line per seed with the control's numbers beside the cell's limits, and
whether the comparison fails it. No benchmark run runs this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from portbench import check, run


def control(workload: dict, config: dict, seed: int, device,
            root: str | None = None) -> dict:
    """The control's largest numbers over the calls a run compares."""
    cspec = workload["check"]
    module = run.config_module(config, root or os.path.dirname(run.HERE))
    worst: dict = {}
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        bench = module.Bench(config, workload, seed, device, tmp)
        calls, qs = check.sample(seed, cspec["calls"], bench.n_queries,
                                 cspec)
        for c in calls:
            for k, v in bench.control(c, qs).items():
                worst[k] = max(worst.get(k, -np.inf), v)
    return worst


def main(argv=None, device=None, root: str | None = None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    root = root or os.path.dirname(run.HERE)
    _bench, workload, config = run.load_cell(args.workload, root)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("portbench.control: no CUDA card", file=sys.stderr)
            return 2
        device = "cuda"
    device = torch.device(device)
    limits = workload["check"]["limits"]
    for seed in args.seeds:
        got = control(workload, config, seed, device, root)
        fails, table = check.verdict(got, limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fails": not fails,
                          "numbers": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
