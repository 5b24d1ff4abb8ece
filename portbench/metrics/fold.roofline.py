"""fold.roofline: the fold's least time over its ``fold`` seconds, in
percent. The least time of a call is the larger of 2 N_q N_s K operations
at the peak of the fold precision the configuration states and the
fold's least bytes at the HBM peak (``counting``); the same work is
counted whatever implements it."""

from portbench import counting


def read(r):
    cfg = r["config"]
    k = counting.embed_dim(cfg["net"], cfg["resolution"])
    least = secs = 0.0
    for c in r["calls"]:
        if not c["ok"]:
            continue
        t = counting.least_seconds(
            counting.fold_ops(c["n_q"], c["n_s"], k), cfg["precision"]["fold"],
            counting.fold_bytes(c["n_q"], c["n_s"], k,
                                cfg["precision"]["parts"]),
            r["device_kind"])
        if t is None:
            return None
        least += t
        secs += c["fold_s"]
    return 100.0 * least / secs if secs > 0 else None
