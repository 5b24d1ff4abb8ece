"""attack_mfu: the window's least time over its seconds, in percent. A
call's least time is the configuration module's ``least_seconds``: the
whole call's work at the card's peaks (the default module's: the
tower's FLOPs on the images it featurised at the tower precision's peak,
plus the fold's operations at the fold precision's peak)."""

from portbench import counting


def read(r):
    peaks = counting.peaks(r["device_kind"])
    if peaks is None:
        return None
    least_seconds = r["module"].least_seconds
    least = 0.0
    for c in r["calls"]:
        if not c["ok"]:
            continue
        least += least_seconds(r["config"], c, peaks)
    secs = sum(c["seconds"] for c in r["calls"])
    return 100.0 * least / secs if secs > 0 else None
