"""featurise.images_per_s: images the calls featurised (the synthetic
set, and the queries where the held cache was not reused) over the
program's ``featurize`` seconds (``ops/knn.PhaseTimer``: CUDA events
around each block, the block's copy to the card included)."""


def read(r):
    ok = [c for c in r["calls"] if c["ok"]]
    secs = sum(c["featurize_s"] for c in ok)
    images = sum(c["n_s"] + (0 if c["query_reused"] else c["n_q"])
                 for c in ok)
    return images / secs if secs > 0 else None
