"""``count`` segments of equal size (CUB's fixed segment sizes)."""
import numpy as np


def sizes(n, params):
    count = int(params["count"])
    if n % count:
        raise ValueError(f"{count} equal segments do not divide {n} keys")
    return np.full(count, n // count, dtype=np.int64)
