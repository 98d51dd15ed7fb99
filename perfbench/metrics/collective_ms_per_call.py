"""ms a call in which a collective ran on the card: the union of the NCCL
kernels' intervals in the traced window, divided by the calls."""
from perfbench.harness import trace


def read(run):
    if run.events is None or run.world == 1:
        return None
    lo, hi, _ = run.span
    nccl = trace.busy_us(run.events, lo, hi, keep=lambda name: "nccl" in name.lower())
    return nccl / 1e3 / run.calls if nccl > 0 else None
