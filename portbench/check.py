"""The comparison that decides ``correct``: what the timed calls returned,
held against the plain reference (``reference.py``) on a sample drawn
from the seed.

For a sample of the window's calls and a sample of the queries, the
reference embeds the sampled queries and every synthetic image of the
call (regenerated from the seed; its checksum must match the one taken
before the call) and takes every distance in float64. Two numbers per
sampled query, each over ``n = r_q + r_s`` (the squared norms of the
two reference embeddings of the pair the program returned, so that
members' near-zero distances and non-members' large ones weigh alike):

* ``loss_gap``: |the program's distance - the reference's distance of
  the same pair| / n;
* ``nn_gap``: (the reference's distance of the returned pair - the
  reference's least distance over the whole set) / n: how far the
  returned image is from the nearest one. 0 where they agree.

The largest of each over the sample is compared with its limit in the
workload file. The control (``control.py``) takes the same numbers of the
reference itself computed one precision step below the configuration's
fold: parts rounded to ``levels`` steps of their static bounds.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import reference, traffic


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


class _Scan:
    """Running reference minimum over a synthetic set for the sampled
    queries, and the reference's distance of the program's pairs."""

    def __init__(self, eq: torch.Tensor, picks: torch.Tensor | None):
        m, dev = eq.shape[0], eq.device
        self.eq, self.rq = eq, (eq * eq).sum(1)
        self.best = torch.full((m,), torch.inf, dtype=torch.float64,
                               device=dev)
        self.picks = picks
        self.d_pick = torch.full((m,), torch.nan, dtype=torch.float64,
                                 device=dev)
        self.rs_pick = torch.full_like(self.d_pick, torch.nan)

    def fold(self, es: torch.Tensor, col0: int) -> tuple:
        rs = (es * es).sum(1)
        d = self.rq[:, None] + rs[None, :] - 2.0 * (self.eq @ es.T)
        self.best = torch.minimum(self.best, d.min(1).values)
        if self.picks is not None:
            local = self.picks - col0
            hit = (local >= 0) & (local < es.shape[0])
            rows = torch.nonzero(hit).flatten()
            cols = local[rows]
            self.d_pick[rows] = d[rows, cols]
            self.rs_pick[rows] = rs[cols]
        return rs, d


class _Control:
    """The reference folded at ``levels`` steps per part: its own argmin
    (first index on ties), its own distance of the pair it picks, and the
    reference's distance and norm of that pair."""

    def __init__(self, eq, rq, widths, bounds, levels):
        self.widths, self.bounds, self.levels = widths, bounds, levels
        self.q_int = reference.quantize(eq, widths, bounds, levels)
        self.rq = rq
        m = eq.shape[0]
        self.best = torch.full((m,), torch.inf, dtype=torch.float64,
                               device=eq.device)
        self.d_pick = torch.full_like(self.best, torch.nan)
        self.rs_pick = torch.full_like(self.best, torch.nan)

    def fold(self, es: torch.Tensor, rs: torch.Tensor, d_ref: torch.Tensor
             ) -> None:
        s_int = reference.quantize(es, self.widths, self.bounds, self.levels)
        d = self.rq[:, None] + rs[None, :] - 2.0 * reference.quantized_cross(
            self.q_int, s_int, self.widths, self.bounds, self.levels)
        v, i = d.min(1)
        better = v < self.best
        self.best = torch.where(better, v, self.best)
        self.d_pick = torch.where(
            better, d_ref.gather(1, i[:, None]).squeeze(1), self.d_pick)
        self.rs_pick = torch.where(better, rs[i], self.rs_pick)


def _gaps(loss: torch.Tensor, d_pick: torch.Tensor, rs_pick: torch.Tensor,
          rq: torch.Tensor, best: torch.Tensor) -> dict:
    n = rq + rs_pick
    return {"loss_gap": float(((loss - d_pick).abs() / n).max()),
            "nn_gap": float(((d_pick - best) / n).max())}


def compare_call(*, config: dict, traffic_spec: dict, weights: dict,
                 seed: int, call: int, members: np.ndarray,
                 q_images: np.ndarray, device, block: int,
                 picks: np.ndarray | None = None,
                 losses: np.ndarray | None = None,
                 control_levels: int | None = None,
                 checksum: int | None = None) -> dict:
    """The numbers of one call: the program's (``picks`` and ``losses`` of
    the sampled queries) and, with ``control_levels``, the control's.
    ``bad_indices`` counts picks outside the set, ``set_mismatch`` is 1
    where the regenerated set's checksum differs from ``checksum``."""
    net, res = config["net"], config["resolution"]
    with torch.inference_mode():
        syn = traffic.synthetic(traffic_spec, res, seed, call, members,
                                device)
        n_s = syn.shape[0]
        out = {"set_mismatch": int(checksum is not None
                                   and traffic.checksum(syn) != checksum)}
        eq = reference.embed(torch.from_numpy(q_images).to(device), weights,
                             net).double()
        pk = None
        if picks is not None:
            pk = torch.from_numpy(picks.astype(np.int64)).to(device)
            bad = (pk < 0) | (pk >= n_s)
            out["bad_indices"] = int(bad.sum())
            pk = torch.where(bad, torch.zeros_like(pk), pk)
        scan = _Scan(eq, pk)
        ctrl = None
        if control_levels is not None:
            ctrl = _Control(eq, scan.rq, reference.part_widths(net, res),
                            reference.part_bounds(weights["lins"], net, res),
                            control_levels)
        for lo in range(0, n_s, block):
            es = reference.embed(syn[lo:lo + block], weights, net).double()
            rs, d = scan.fold(es, lo)
            if ctrl is not None:
                ctrl.fold(es, rs, d)
            del es, d
        if picks is not None:
            loss = torch.from_numpy(np.asarray(losses, np.float64)).to(device)
            out.update(_gaps(loss, scan.d_pick, scan.rs_pick, scan.rq,
                             scan.best))
        if ctrl is not None:
            out["control"] = _gaps(ctrl.best, ctrl.d_pick, ctrl.rs_pick,
                                   scan.rq, scan.best)
    return out


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
