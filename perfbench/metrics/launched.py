"""Device time of the work that the program launched inside its own host
spans. Each launch is a ``cuda_runtime`` or ``cuda_driver`` event on the
host; the kernel, copy or memset it started on the card carries the same
``correlation`` id in the trace's ``args``. A launch belongs to a span
whose interval holds its start: the benchmark's one caller makes every
call, spans and launches on one thread."""
from bisect import bisect_right

from perfbench.harness import trace

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def _spans(events, names, lo, hi):
    """The sorted (start, end) of the host spans named in `names` that lie
    in [lo, hi]."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e["name"] in names
                  and lo <= e["ts"] and e["ts"] + e["dur"] <= hi)


def _inside(spans, ts):
    """Whether `ts` lies in one of `spans`, which do not overlap one another
    (the spans of one name, or of names that never nest)."""
    i = bisect_right(spans, (ts, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= ts < spans[i][1]


def device_ms_per_call(run, inside, outside=()):
    """ms a call of the card's work launched inside a span named in `inside`
    and inside none named in `outside`: the union of those device events'
    intervals, clipped to the window, over the calls. None where the trace
    holds no such span or no device work launched in one."""
    if run.events is None:
        return None
    lo, hi, _ = run.span
    ins, outs = _spans(run.events, inside, lo, hi), _spans(run.events, outside, lo, hi)
    if not ins:
        return None
    launched = set()
    for e in run.events:
        if e.get("cat") not in LAUNCH_CATEGORIES:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr is not None and _inside(ins, e["ts"]) and not _inside(outs, e["ts"]):
            launched.add(corr)
    found = []
    for e in run.events:
        if (e.get("cat") in trace.DEVICE_CATEGORIES
                and e.get("args", {}).get("correlation") in launched):
            a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if b > a:
                found.append((a, b))
    if not found:
        return None
    return sum(b - a for a, b in trace.merged(sorted(found))) / 1e3 / run.calls
