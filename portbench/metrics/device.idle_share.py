"""device.idle_share: the share of the timed calls in which nothing ran
on the card (the profiler's device intervals, clipped to the calls'
ranges), in percent."""


def read(r):
    t = r["trace"]
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
