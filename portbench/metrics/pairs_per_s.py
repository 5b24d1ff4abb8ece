"""pairs_per_s: query pairs searched (N_q x N_s of every call that
returned) over the window's seconds, every call's time counted."""


def read(r):
    secs = sum(c["seconds"] for c in r["calls"])
    pairs = sum(c["n_q"] * c["n_s"] for c in r["calls"] if c["ok"])
    return pairs / secs if secs > 0 else None
