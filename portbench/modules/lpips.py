"""The default configuration module: the fbb attack with ``l2 + 0.2 *
LPIPS`` on a fresh synthetic set a call (a configuration without a
``module`` key runs this).

* set-up: the tower's weights from the seed (``weights.py``, with
  ``nets.py`` as the network table), handed to the program as an npz in
  the run's temporary directory, the program's ``AttackConfig``, and the
  query sets from the seed (``traffic.queries``);
* a call's input: the synthetic set drawn on the card from (seed, call,
  stream) with the members' noisy copies planted (``traffic.synthetic``),
  taken to the host, and its checksum;
* the timed call: ``ganleaks_tpu_torch.attack.fbb.attack_arrays`` on that
  set and the queries, with the program's query cache held across calls;
* the comparison: for the sampled queries, the plain reference
  (``reference.py``) embeds them and every image of the regenerated set
  and takes every distance in float64. Two numbers a sampled query, each
  over ``n = r_q + r_s`` (the squared norms of the two reference
  embeddings of the pair the program returned, so that members'
  near-zero distances and non-members' large ones weigh alike):

  - ``loss_gap``: |the program's distance - the reference's distance of
    the same pair| / n;
  - ``nn_gap``: (the reference's distance of the returned pair - the
    reference's least distance over the whole set) / n: how far the
    returned image is from the nearest one. 0 where they agree.

  ``bad_indices`` counts picks outside the set, ``set_mismatch`` a
  regenerated set whose checksum differs from the one taken before the
  call, ``engine_departures`` calls that resolved another engine or
  embedding dtype than the configuration states;
* the control: the same numbers of the reference itself folded one
  precision step below the configuration's fold (int8 parts become int4:
  7 steps of the same static bounds);
* the least seconds of a call: the tower's FLOPs on the images it
  featurised (the reused queries are not featurised again) at the tower
  precision's peak, plus the fold's operations at the fold precision's
  peak (``counting.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench import counting, reference, traffic, weights

INT4_LEVELS = 7


class Bench:
    """One run's configuration: ``Bench(config, workload, seed, device,
    tmp)`` is the set-up; the harness then calls :meth:`call_input`,
    :meth:`timed_call` and :meth:`record` a call, :meth:`release` once the
    window has closed, and :meth:`compare` on the sampled calls."""

    # numbers of :meth:`compare` that add up over the compared calls (the
    # others take the largest)
    COUNTS = ("bad_indices", "set_mismatch")

    def __init__(self, config: dict, workload: dict, seed: int, device,
                 tmp: str):
        from ganleaks_tpu_torch.attack import fbb
        from ganleaks_tpu_torch.config import AttackConfig
        from ganleaks_tpu_torch.ops.lpips.epilogue import tap_epilogue

        self._fbb, self._tap_epilogue = fbb, tap_epilogue
        self.config, self.spec = config, workload["traffic"]
        self.seed, self.device = seed, device
        self.res = config["resolution"]
        self.block = workload["check"]["block"]
        self.weights = weights.make(config, seed, device)
        npz = os.path.join(tmp, "lpips.npz")
        weights.save_npz(self.weights, config["net"], npz)
        self.cfg = AttackConfig(**config["attack"], lpips_weights=npz)
        self.pos, self.neg = traffic.queries(self.spec, self.res, seed,
                                             device)
        self.n_queries = len(self.pos) + len(self.neg)
        self.sweep: dict = {}
        self._k2 = 0

    def _synthetic(self, call: int, stream: int = traffic.WINDOW
                   ) -> torch.Tensor:
        return traffic.synthetic(self.spec, self.res, self.seed, call,
                                 self.pos, self.device, stream)

    def call_input(self, call: int, stream: int) -> tuple[np.ndarray, int]:
        """The call's synthetic set on the host, and its checksum."""
        syn = self._synthetic(call, stream)
        total = traffic.checksum(syn)
        host = syn.cpu().numpy()
        del syn
        self._k2 = self._tap_epilogue.launches
        return host, total

    def timed_call(self, syn: np.ndarray, logger) -> dict:
        return self._fbb.attack_arrays(
            self.cfg, syn, self.pos, self.neg, device=self.device,
            sweep_cache=self.sweep, logger=logger)

    def record(self, syn: np.ndarray, out: dict | None,
               logged: list[dict]) -> dict:
        """What a call's record carries besides ``seconds``, ``ok`` and
        ``counters``: the pairs' shape, K2's launches, the engine the
        program resolved and, where the call returned, its phase seconds
        and plan."""
        rec = {"n_q": self.n_queries, "n_s": len(syn),
               "k2_launches": self._tap_epilogue.launches - self._k2}
        for r in logged:
            if "engine_resolved" in r:
                rec["engine"], rec["embed_dtype"] = (r["engine_resolved"],
                                                     r["dtype"])
        if out is not None:
            rec.update({k: out[k] for k in (
                "featurize_s", "fold_s", "lpips_init_s", "host_copy_s",
                "oom_resumes", "sets_on_device")})
            rec["query_reused"] = bool(out["plan"]["query_reused"])
            rec["plan"] = out["plan"]
        return rec

    def answers(self, out: dict) -> dict:
        """What the comparison judges: each query's loss and pick."""
        return {"loss": np.concatenate([out["pos_loss"], out["neg_loss"]]),
                "idx": np.concatenate([out["pos_nn_idx"],
                                       out["neg_nn_idx"]])}

    def departures(self, calls: list[dict]) -> dict:
        """Numbers judged on the window's records: returned calls that
        resolved another engine or embedding dtype than stated."""
        cfg = self.config
        return {"engine_departures": sum(
            c.get("engine") != cfg["engine_resolved"]
            or c.get("embed_dtype") != cfg["embed_dtype"]
            for c in calls if c["ok"])}

    def release(self) -> None:
        """The program's state goes before the reference runs."""
        self.sweep.clear()

    def compare(self, call: int, answers: dict, qs: np.ndarray,
                checksum: int) -> dict:
        """The numbers of call ``call`` on the sampled queries ``qs``."""
        return self._scan(call, qs, picks=answers["idx"][qs],
                          losses=answers["loss"][qs], checksum=checksum)

    def control(self, call: int, qs: np.ndarray) -> dict:
        """The control's numbers on call ``call``'s set."""
        return self._scan(call, qs, control_levels=INT4_LEVELS)["control"]

    def reference_set(self, call: int, checksum: int | None
                      ) -> tuple[torch.Tensor, int]:
        """Window call ``call``'s set as the reference makes it (uint8
        NHWC on the device), and 1 where it is not the set the call was
        given (its checksum differs from ``checksum``), else 0."""
        syn = self._synthetic(call)
        return syn, int(checksum is not None
                        and traffic.checksum(syn) != checksum)

    def _scan(self, call: int, qs: np.ndarray, *,
              picks: np.ndarray | None = None,
              losses: np.ndarray | None = None,
              control_levels: int | None = None,
              checksum: int | None = None) -> dict:
        """The program's numbers (``picks`` and ``losses`` of the sampled
        queries) and, with ``control_levels``, the control's."""
        net, res, device = self.config["net"], self.res, self.device
        block = self.block
        with torch.inference_mode():
            syn, mismatch = self.reference_set(call, checksum)
            n_s = syn.shape[0]
            out = {"set_mismatch": mismatch}
            q_images = np.concatenate([self.pos, self.neg])[qs]
            eq = reference.embed(torch.from_numpy(q_images).to(device),
                                 self.weights, net).double()
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
                                reference.part_bounds(self.weights["lins"],
                                                      net, res),
                                control_levels)
            for lo in range(0, n_s, block):
                es = reference.embed(syn[lo:lo + block], self.weights,
                                     net).double()
                rs, d = scan.fold(es, lo)
                if ctrl is not None:
                    ctrl.fold(es, rs, d)
                del es, d
            if picks is not None:
                loss = torch.from_numpy(np.asarray(losses, np.float64)).to(
                    device)
                out.update(_gaps(loss, scan.d_pick, scan.rs_pick, scan.rq,
                                 scan.best))
            if ctrl is not None:
                out["control"] = _gaps(ctrl.best, ctrl.d_pick, ctrl.rs_pick,
                                       scan.rq, scan.best)
        return out


def least_seconds(config: dict, call: dict, peaks: dict) -> float:
    """The least seconds of one returned call at the card's ``peaks``."""
    net, res, prec = config["net"], config["resolution"], config["precision"]
    k = counting.embed_dim(net, res)
    images = call["n_s"] + (0 if call["query_reused"] else call["n_q"])
    return (images * counting.tower_flops(net, res) / peaks[prec["tower"]]
            + counting.fold_ops(call["n_q"], call["n_s"], k)
            / peaks[prec["fold"]])


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
