"""The whole call's share of its roofline, %: the least time of its work
over the card's busy time a call. The least time reads each input byte once
and writes each output byte once at the card's published memory bandwidth
(``peaks.json``), counted from the cell's shapes, whatever kernels run."""
from perfbench.harness import trace


def read(run):
    if run.events is None or run.peak is None:
        return None
    lo, hi, _ = run.span
    busy_s = trace.busy_us(run.events, lo, hi) / 1e6
    if busy_s <= 0:
        return None
    least_s = run.bytes_per_call / run.peak["hbm_bytes_per_s"]
    return 100.0 * least_s / (busy_s / run.calls)
