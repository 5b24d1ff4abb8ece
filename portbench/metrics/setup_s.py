"""setup_s: seconds from the process's start to the first timed call
(imports, kernels loaded or built, weights, query sets, warm-up calls and
the first call's synthetic set)."""


def read(r):
    return r["setup_s"]
