"""setup.host_share: the share of the window in the attack's set-up on
the host (``attack_arrays``' ``lpips_init_s``, building or fetching the
featurisers, plus ``host_copy_s``, joining the query sets and staging
both sets on the card), in percent."""


def read(r):
    secs = sum(c["seconds"] for c in r["calls"])
    setup = sum(c["lpips_init_s"] + c["host_copy_s"]
                for c in r["calls"] if c["ok"])
    return 100.0 * setup / secs if secs > 0 else None
