"""fold.pairs_per_s: query pairs over the program's ``fold`` seconds
(``ops/knn.PhaseTimer``: CUDA events around each block's fold)."""


def read(r):
    ok = [c for c in r["calls"] if c["ok"]]
    secs = sum(c["fold_s"] for c in ok)
    pairs = sum(c["n_q"] * c["n_s"] for c in ok)
    return pairs / secs if secs > 0 else None
