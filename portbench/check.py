"""The comparison that decides ``correct``: what the timed calls returned,
held against the plain reference on a sample drawn from the seed.

The harness draws ``spec["calls"]`` of the calls that returned and
``spec["queries"]`` of the queries from the seed; the configuration's
module compares each sampled call with its plain reference
(``modules/lpips.py``'s ``Bench.compare`` by default, which documents its
numbers), and every number is compared with its limit in the workload
file (the counts with 0). The control (``control.py``) takes the same
numbers of the module's reference put in the program's place one
precision step below the configuration's.
"""

from __future__ import annotations

import numpy as np

from portbench import traffic


def sample(seed: int, n_done: int, n_q: int, spec: dict
           ) -> tuple[list[int], np.ndarray]:
    """(calls, queries) to compare, drawn from the seed: ``spec["calls"]``
    of the ``n_done`` completed calls (their positions) and
    ``spec["queries"]`` of the ``n_q`` queries."""
    rng = np.random.default_rng(traffic.sub_seed(seed, 3))
    calls = sorted(int(c) for c in rng.choice(
        n_done, min(spec["calls"], n_done), replace=False))
    qs = np.sort(rng.choice(n_q, min(spec["queries"], n_q), replace=False))
    return calls, qs


def judge(bench, seed: int, calls: list[dict], results: list,
          sums: list[int], spec: dict) -> dict:
    """The numbers of a run: failed calls, the configuration module's
    numbers on the window's records (``bench.departures``) and, on the
    calls and queries drawn from the seed, its comparison of each sampled
    call (``bench.compare``): the counts in ``bench.COUNTS`` add up over
    the calls, every other number takes its largest. ``results`` holds
    each call's answers (None where it raised), ``sums`` each input's
    checksum. With no call returned, every limited number is infinite."""
    done = [i for i, r in enumerate(results) if r is not None]
    numbers = {"failed_calls": sum(not c["ok"] for c in calls),
               **bench.departures(calls), **dict.fromkeys(bench.COUNTS, 0)}
    if not done:
        numbers.update(dict.fromkeys(spec["limits"], np.inf))
        return numbers
    picks, qs = sample(seed, len(done), bench.n_queries, spec)
    for j in picks:
        c = done[j]
        got = bench.compare(c, results[c], qs, sums[c])
        for k in bench.COUNTS:
            numbers[k] += got.pop(k)
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, -np.inf), v)
    return numbers


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit. The counts have the limit 0."""
    table = {}
    for name, value in numbers.items():
        limit = limits.get(name, 0)
        table[name] = {"value": value, "limit": limit}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
