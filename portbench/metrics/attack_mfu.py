"""attack_mfu: the window's least time over its seconds, in percent. A
call's least time is the tower's FLOPs on the images it featurised (the
reused queries are not featurised again) at the tower precision's peak,
plus the fold's operations at the fold precision's peak (``counting``)."""

from portbench import counting


def read(r):
    cfg = r["config"]
    net, res, prec = cfg["net"], cfg["resolution"], cfg["precision"]
    peaks = counting.peaks(r["device_kind"])
    if peaks is None:
        return None
    k = counting.embed_dim(net, res)
    least = 0.0
    for c in r["calls"]:
        if not c["ok"]:
            continue
        images = c["n_s"] + (0 if c["query_reused"] else c["n_q"])
        least += (images * counting.tower_flops(net, res) / peaks[prec["tower"]]
                  + counting.fold_ops(c["n_q"], c["n_s"], k)
                  / peaks[prec["fold"]])
    secs = sum(c["seconds"] for c in r["calls"])
    return 100.0 * least / secs if secs > 0 else None
