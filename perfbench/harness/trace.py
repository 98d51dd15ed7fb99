"""Reading a ``torch.profiler`` Chrome trace: the card's busy time, its
idle gaps and what the host did in them, and the device operations.

The busy-time arithmetic is a frozen copy of the program's
``runtime/profiler.py`` ``busy_share``: the union of the kernel, copy and
memset intervals, clipped to a host span. Timestamps are microseconds.
"""
from __future__ import annotations

import json
import re
from bisect import bisect_right

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "perfbench.window"


def load(path) -> list[dict]:
    """The complete ('X') events of a Chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def kernel_name(event_name: str) -> str:
    """A kernel's function name without namespace, template arguments or
    parameters (``void ns::f<2>(int)`` -> ``f``); a mangled name whole."""
    m = re.search(r"(\w+)(?:<|\()", event_name)
    return m.group(1) if m and not event_name.startswith("_Z") else event_name


def span(events, name: str = WINDOW_SPAN):
    """(start, end, thread) of the one host span called `name`."""
    found = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == name]
    if len(found) != 1:
        raise ValueError(f"the trace holds {len(found)} host spans named {name!r}, not one")
    e = found[0]
    return e["ts"], e["ts"] + e["dur"], e.get("tid")


def device_intervals(events, lo, hi, keep=None) -> list[tuple[float, float, str]]:
    """Device events (kernels, copies, memsets) clipped to [lo, hi], sorted;
    `keep`, if given, selects by the event's name."""
    out = []
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES and (keep is None or keep(e["name"])):
            a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if b > a:
                out.append((a, b, e["name"]))
    out.sort()
    return out


def merged(intervals) -> list[tuple[float, float]]:
    """The union of sorted intervals, as disjoint intervals."""
    out = []
    for a, b, *_ in intervals:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def busy_us(events, lo, hi, keep=None) -> float:
    """Microseconds of [lo, hi] in which a device operation ran."""
    return sum(b - a for a, b in merged(device_intervals(events, lo, hi, keep)))


def device_ops(events, lo, hi, top: int = 10) -> list[list]:
    """The device operations that took the most time in [lo, hi]: kernels
    by function name, copies and memsets by their event name; seconds."""
    total: dict[str, float] = {}
    for a, b, name in device_intervals(events, lo, hi):
        key = kernel_name(name)
        total[key] = total.get(key, 0.0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e6] for k, v in ranked]


def idle_gaps(events, lo, hi, thread=None, top: int = 10) -> list[list]:
    """The card's idle time in [lo, hi], summed by what the host was doing:
    the innermost host event of `thread` that spans the middle of each gap
    (``host`` where none does); seconds, the largest sums first."""
    busy = merged(device_intervals(events, lo, hi))
    gaps, end = [], lo
    for a, b in busy:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    host = sorted((e["ts"], -e["dur"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in HOST_CATEGORIES and (thread is None or e.get("tid") == thread))
    starts = [h[0] for h in host]
    total: dict[str, float] = {}
    stack: list = []
    pushed = 0
    for a, b in gaps:
        mid = (a + b) / 2
        upto = bisect_right(starts, mid)
        for h in host[pushed:upto]:
            while stack and stack[-1][2] <= h[0]:
                stack.pop()
            stack.append(h)
        pushed = max(pushed, upto)
        while stack and stack[-1][2] <= mid:
            stack.pop()
        name = stack[-1][3] if stack else "host"
        total[name] = total.get(name, 0.0) + (b - a)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e6] for k, v in ranked]
