"""Seconds from the process's start to the first timed call: imports, the
card's context, loading (and in a checkout's first run building) the
kernels, the inputs made from the seed, the warm-up calls."""
COMBINE = "max"


def read(run):
    return run.first_call - run.t0
