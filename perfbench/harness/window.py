"""The measured window: a closed loop with one caller.

Each call is synchronous: the host clock runs from the call until
``torch.cuda.synchronize()`` returns, and the next call starts then. The
window cycles through a pool of inputs made in set-up. For each slot of the
pool one answer is kept for the check after the window: that of the slot's
visit number drawn from the seed (``keep``), or its last visit where the
window ends before it.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    latencies: list = field(default_factory=list)   # seconds, call to synchronize
    enqueue: list = field(default_factory=list)     # seconds, call until it returned
    calls: int = 0
    failed: int = 0
    error: str = ""
    first_call: float = 0.0                         # perf_counter at the first call
    window_s: float = 0.0
    visits: list = field(default_factory=list)      # calls made on each slot


def closed_loop(call, pool, kept, keep, seconds, sync, *, max_calls=None, span=None,
                catch=True) -> Window:
    """Call ``call(pool[i % len(pool)])`` until `seconds` have passed (or
    `max_calls` calls), each followed by ``sync()``. ``kept[s]`` receives
    the answer of slot s's visit ``keep[s]``. With `catch`, a call that
    raises ends the window and counts as failed."""
    span = span or (lambda name: contextlib.nullcontext())
    w = Window(visits=[0] * len(pool))
    clock = time.perf_counter
    w.first_call = start = clock()
    while True:
        s = w.calls % len(pool)
        t0 = clock()
        out = None
        with span("perfbench.call"):
            try:
                out = call(pool[s])
            except Exception as exc:  # a failed call ends the window: it is counted
                if not catch:
                    raise
                w.failed += 1
                w.error = f"{type(exc).__name__}: {exc}"
        t1 = clock()
        with span("perfbench.sync"):
            sync()
        t2 = clock()
        w.latencies.append(t2 - t0)
        w.enqueue.append(t1 - t0)
        if out is not None and w.visits[s] <= keep[s]:
            kept[s] = out
        out = None  # the answer is freed before the next call
        w.visits[s] += 1
        w.calls += 1
        if w.failed or t2 - start >= seconds or (max_calls is not None
                                                 and w.calls >= max_calls):
            w.window_s = t2 - start
            return w
