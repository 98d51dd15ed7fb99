"""The card's idle share of the traced window, %: 100 x (1 - the union of
its kernel, copy and memset intervals over the window)."""
from perfbench.harness import trace


def read(run):
    if run.events is None:
        return None
    lo, hi, _ = run.span
    busy = trace.busy_us(run.events, lo, hi)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (hi - lo))
