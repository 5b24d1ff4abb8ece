"""k2.roofline: the tap epilogue kernel's (K2, ``csrc/tap_epilogue.cu``)
least time over its device time in the trace, in percent. Least time:
each tap element read once in the tower's dtype and each part element
written once in the part's dtype (``counting.k2_bytes``), over the images
the calls featurised, at the HBM peak."""

from portbench import counting

KERNEL = "tap_epilogue"


def read(r):
    t = r["trace"]
    if t is None:
        return None
    secs = sum(v for k, v in t["ops"].items() if KERNEL in k)
    peaks = counting.peaks(r["device_kind"])
    if secs <= 0 or peaks is None:
        return None
    cfg = r["config"]
    images = sum(c["n_s"] + (0 if c["query_reused"] else c["n_q"])
                 for c in r["calls"] if c["ok"])
    nbytes = counting.k2_bytes(cfg["net"], cfg["resolution"], images,
                               cfg["precision"]["tower"],
                               cfg["precision"]["parts"])
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / secs
