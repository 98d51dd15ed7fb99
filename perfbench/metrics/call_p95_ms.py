"""The 95th percentile of all calls' latencies in the window, ms: host
clock from the call until ``torch.cuda.synchronize()`` returned."""
import numpy as np

COMBINE = "max"


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3
