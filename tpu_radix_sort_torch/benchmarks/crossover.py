"""Card against CPU: the size from which the card's sort beats the host's.

Counterpart of ``benchmarks/crossover.py``. The reference claims that the
GPU sort beats the CPU above ~100,000 elements, against the host's
``Array.prototype.sort``; this is that experiment for the port: the default
engine (keys-only, and key + rank with ``values_are_ranks=True``) against
the native C++ LSD radix sort (``runtime/native/sort.cc``) at 2^10..2^24
in steps of 4x.

Columns: the card's time (``runtime.timing.device_time``: CUDA events over
back-to-back calls; at small n that is the host's time to launch a sort's
kernels and ops, which the card waits for); "1-shot", the host wall time of one call plus
``torch.cuda.synchronize()``, the median of 5 (what a caller that waits
for each sort sees); the CPU sort's time, the median of 5 ``perf_counter``
readings, and which CPU sort ran.

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.crossover``
(``check`` then ``main``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.sort import sort
from ..runtime.cpu_baseline import cpu_sort, sort_kind
from ..runtime.timing import device_time
from ..utils import interop

SIZES = tuple(1 << e for e in range(10, 25, 2))
SEED = 7
REPS = 5


def inputs(n: int, rng: np.random.Generator):
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return keys, np.arange(n, dtype=np.uint32)


def cpu_time(fn, reps: int = REPS) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def oneshot_time(fn, *args, reps: int = REPS) -> float:
    """Host wall seconds of one call and a synchronize, the median of `reps`
    after one warm call."""
    fn(*args)
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _same(t: torch.Tensor, want: np.ndarray) -> bool:
    got = interop.to_numpy(t)
    return got.dtype == want.dtype and np.array_equal(got, want)


def check(device="cuda", seed=SEED, sizes=SIZES) -> int:
    """Every size: keys-only and key + rank through the default engine,
    byte for byte against ``cpu_sort``. Raises on a difference; returns 0."""
    dev = interop.resolve_device(device)
    rng = np.random.default_rng(seed)
    for n in sizes:
        keys, vals = inputs(n, rng)
        k, v = interop.from_numpy(keys, dev), interop.from_numpy(vals, dev)
        want_k, want_v = cpu_sort(keys, vals)
        if not _same(sort(k), want_k):
            raise AssertionError(f"keys-only sort of {n} differs from cpu_sort")
        gk, gv = sort(k, v, values_are_ranks=True)
        if not (_same(gk, want_k) and _same(gv, want_v)):
            raise AssertionError(f"key + rank sort of {n} differs from cpu_sort")
    return 0


def _fmt(t: float) -> str:
    return f"{t * 1e6:9.1f}u" if t < 1e-3 else f"{t * 1e3:9.2f}m"


def main(device="cuda", seed=SEED, sizes=SIZES) -> list[dict]:
    """Time every size; print the table and the crossover; a row each."""
    dev = interop.resolve_device(device)
    rng = np.random.default_rng(seed)
    kind = sort_kind()
    print(f"CPU baseline: {kind}")
    print(f"{'n':>10} | {'card keys':>10} {'1-shot':>10} {'CPU keys':>10} {'win':>6} | "
          f"{'card k+v':>10} {'CPU k+v':>10} {'win':>6}")
    rows = []
    for n in sizes:
        keys, vals = inputs(n, rng)
        k, v = interop.from_numpy(keys, dev), interop.from_numpy(vals, dev)
        t_k = device_time(sort, k)
        t_one = oneshot_time(sort, k)
        t_kv = device_time(lambda a, b: sort(a, b, values_are_ranks=True), k, v)
        c_k = cpu_time(lambda: cpu_sort(keys))
        c_kv = cpu_time(lambda: cpu_sort(keys, vals))
        print(f"2^{n.bit_length() - 1:<8} | {_fmt(t_k)} {_fmt(t_one)} {_fmt(c_k)} "
              f"{c_k / t_k:5.1f}x | {_fmt(t_kv)} {_fmt(c_kv)} {c_kv / t_kv:5.1f}x", flush=True)
        rows.append({"n": n, "card_keys_ms": t_k * 1e3, "one_shot_ms": t_one * 1e3,
                     "cpu_keys_ms": c_k * 1e3, "card_kv_ms": t_kv * 1e3,
                     "cpu_kv_ms": c_kv * 1e3, "cpu_sort": kind})
    for what, card, cpu in (("keys-only", "card_keys_ms", "cpu_keys_ms"),
                            ("1-shot keys-only", "one_shot_ms", "cpu_keys_ms"),
                            ("key + rank", "card_kv_ms", "cpu_kv_ms")):
        win = next((r["n"] for r in rows if r[card] < r[cpu]), None)
        print(f"crossover, {what}: "
              + (f"the card wins from n = {win:,}" if win else "the card never wins here"))
    return rows


if __name__ == "__main__":
    check()
    main()
