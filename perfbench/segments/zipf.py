"""Ragged segments whose sizes follow a Zipf law, as CUB's segmented sort
benchmarks' power-law sizes: ``count`` segments, weights drawn from
Zipf(``exponent``) with ``sizes_seed``, the keys dealt out by a
multinomial draw, every segment at least 1."""
import numpy as np


def sizes(n, params):
    count = int(params["count"])
    rng = np.random.default_rng(int(params["sizes_seed"]))
    w = rng.zipf(float(params["exponent"]), count).astype(np.float64)
    return rng.multinomial(n - count, w / w.sum()).astype(np.int64) + 1
