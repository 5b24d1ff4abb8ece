"""The control of a cell's comparison: the plain reference put in the
program's place one precision step below the configuration's fold (int8
parts become int4: 7 steps of the same static bounds), read by the same
numbers as a run's ``check``. The limits must fail it.

    python3 -m portbench.control --workload vgg16-64.grid --seeds 1 2 3

For each seed: the cell's weights, query sets and the synthetic sets of
as many calls as a run compares, drawn as a run draws them; one JSON line
per seed with the control's numbers beside the cell's limits, and
whether the comparison fails it. No benchmark run runs this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from portbench import check, run, traffic, weights

INT4_LEVELS = 7


def control(workload: dict, config: dict, seed: int, device) -> dict:
    """The control's largest numbers over the calls a run compares."""
    spec, cspec = workload["traffic"], workload["check"]
    res = config["resolution"]
    w = weights.make(config, seed, device)
    pos, neg = traffic.queries(spec, res, seed, device)
    queries = np.concatenate([pos, neg])
    calls, qs = check.sample(seed, cspec["calls"], len(queries), cspec)
    worst: dict = {}
    for c in calls:
        got = check.compare_call(
            config=config, traffic_spec=spec, weights=w, seed=seed, call=c,
            members=pos, q_images=queries[qs], device=device,
            block=cspec["block"], control_levels=INT4_LEVELS)["control"]
        for k, v in got.items():
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
        got = control(workload, config, seed, device)
        fails, table = check.verdict(got, limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fails": not fails,
                          "numbers": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
