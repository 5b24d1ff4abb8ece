"""tower.roofline: the LPIPS tower's least time over the device seconds
of what was launched inside the program's span ``lpips.tower`` (the
trace's ``launched``), in percent. Least time: the tower's FLOPs
(``counting.tower_flops``) on the images the calls featurised (the
reused queries are not featurised again) at the peak of the tower
precision the configuration states."""

from portbench import counting

SPAN = "lpips.tower"


def read(r):
    t = r["trace"]
    if t is None:
        return None
    secs = t["launched"].get(SPAN, 0.0)
    peaks = counting.peaks(r["device_kind"])
    if secs <= 0 or peaks is None:
        return None
    cfg = r["config"]
    images = sum(c["n_s"] + (0 if c["query_reused"] else c["n_q"])
                 for c in r["calls"] if c["ok"])
    flops = images * counting.tower_flops(cfg["net"], cfg["resolution"])
    return 100.0 * flops / peaks[cfg["precision"]["tower"]] / secs
