"""Tracing and profiling hooks.

Counterpart of ``tpu_radix_sort/runtime/profiler.py``, which wraps
``jax.profiler``. Here:

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  records host and CUDA activity for the enclosed block and writes a
  Chrome/Perfetto ``trace.json`` (open it in ``ui.perfetto.dev`` or
  ``chrome://tracing``);
- :func:`annotate`: a named span, ``torch.profiler.record_function`` and,
  where CUDA is present, an NVTX range, so that a block shows up labelled
  in a trace and in NVTX-aware tools;
- :func:`load_events`, :func:`kernel_counts`, :func:`busy_share`: read a
  written trace back: the launches of named kernels, and the share of a
  span in which the card was busy (kernels, copies, memsets).

As in the JAX package, the ops carry no spans of their own: a caller
annotates the blocks it wants to see.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

import torch

from ..utils import interop

TRACE_FILE = "trace.json"
# The trace's categories of device work: what counts as the card being busy.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def default_log_dir() -> str:
    """$TRS_TRACE_DIR, or a directory of the port's own under the temp dir."""
    return os.environ.get("TRS_TRACE_DIR") or os.path.join(tempfile.gettempdir(),
                                                           "trs_torch_trace")


@contextlib.contextmanager
def trace(log_dir: str | None = None, device=None):
    """Profile the enclosed block; yields `log_dir`, where ``trace.json``
    is written when the block ends.

    On the CUDA card (the default) it records host and CUDA activity, and
    raises where CUDA is missing; ``device="cpu"`` records host activity
    alone. The card is synchronized before the profile stops, so that
    kernels still queued at the end of the block are in the trace.
    """
    log_dir = log_dir or default_log_dir()
    dev = interop.resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """A named span: ``with annotate('reorder-pass-3'): ...``. An NVTX range
    is pushed only where CUDA is present (a CPU build of torch has no NVTX)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def load_events(log_dir: str) -> list[dict]:
    """The complete ('X') events of the ``trace.json`` in `log_dir`."""
    with open(os.path.join(log_dir, TRACE_FILE)) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def kernel_name(event_name: str) -> str:
    """The function name of a kernel event, without namespace, template
    arguments or parameters (``void (anonymous namespace)::f<2, 2>(...)``
    -> ``f``); a mangled name is returned whole."""
    m = re.search(r"(\w+)(?:<|\()", event_name)
    return m.group(1) if m and not event_name.startswith("_Z") else event_name


def kernel_counts(events, names) -> dict[str, int]:
    """How many kernel events carry each of `names` as their function name."""
    counts = dict.fromkeys(names, 0)
    for e in events:
        if e.get("cat") == "kernel":
            name = kernel_name(e["name"])
            if name in counts:
                counts[name] += 1
    return counts


def span(events, name: str) -> tuple[float, float]:
    """(start, end) in microseconds of the one host span called `name`."""
    found = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == name]
    if len(found) != 1:
        raise ValueError(f"the trace holds {len(found)} host spans named {name!r}, not one")
    return found[0]["ts"], found[0]["ts"] + found[0]["dur"]


def busy_share(events, name: str) -> dict:
    """The card's busy time within the host span `name`: the union of its
    kernel, copy and memset intervals, each clipped to the span. Returns the
    span's and the busy time in ms, their ratio and the device events seen."""
    lo, hi = span(events, name)
    iv = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events
                if e.get("cat") in DEVICE_CATEGORIES)
    busy, end, n = 0.0, lo, 0
    for a, b in iv:
        if b <= a:
            continue
        n += 1
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"span_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (hi - lo) if hi > lo else 0.0, "device_events": n}
