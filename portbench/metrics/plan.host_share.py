"""plan.host_share: the host seconds of the program's spans
``fbb.resolve_engine`` ('auto' resolved from the parts' shapes) and
``knn.plan`` (a search's spec, probe, fingerprint and stream plan)
inside the timed calls (the trace's ``spans``), over the calls' seconds
in the trace, in percent."""

SPANS = ("fbb.resolve_engine", "knn.plan")


def read(r):
    t = r["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    secs = sum(t["spans"].get(name, 0.0) for name in SPANS)
    return 100.0 * secs / t["window_s"] if secs > 0 else None
