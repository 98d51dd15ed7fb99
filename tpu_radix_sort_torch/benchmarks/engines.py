"""Bitonic against radix: the size from which the radix engine wins.

The sweep behind ``ops/sort.py`` ``AUTO_RADIX_MIN_N``, the per-key-width
count from which ``method='auto'`` takes the radix engine. For uint32,
uint64 and bfloat16 keys, each keys-only, with a u32 rank
(``values_are_ranks=True``) and with an 8-byte value, it times
``method='bitonic'`` and ``method='radix'`` at n = 2^10..2^26 and at
3 * 2^k in between (the network pads or splits such lengths), with
``runtime.timing.device_time`` (CUDA events over back-to-back calls);
below 2^18, where launches set the pace, also the host wall time of one
call and a synchronize. One more row times ``check_order=True`` on
unsorted u32 key + rank input at the largest size, where the radix engine
checks the order before every second pass.

For each width it prints the smallest n from which radix wins at every
larger measured size, payload, `check_order` and timing (:func:`threshold`).

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.engines``
(``check`` then ``main``; ``--json PATH`` writes the rows).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.sort import sort
from ..runtime.timing import device_time
from ..utils import interop
from .crossover import oneshot_time

SEED = 11
KEYS = ("uint32", "uint64", "bfloat16")
PAYLOADS = ("keys", "rank", "value8")
ENGINES = ("bitonic", "radix")
SIZES_ALL = tuple(sorted([1 << e for e in range(4, 31)] + [3 << e for e in range(3, 29)]))
SIZES = tuple(n for n in SIZES_ALL if 1 << 10 <= n <= 1 << 26)
ONESHOT_BELOW = 1 << 18
CHECK_SIZES = (1000, 3 << 10, 1 << 14)


def inputs(key: str, payload: str, n: int, device, seed: int = SEED):
    """Uniform random keys of dtype `key` and the payload (None, a u32
    iota, or random 8-byte values), on `device`."""
    g = torch.Generator(device=device).manual_seed(seed + n)
    width = {"uint32": torch.int32, "uint64": torch.int64, "bfloat16": torch.int16}[key]
    info = torch.iinfo(width)
    bits = torch.randint(info.min, info.max, (n,), dtype=width, device=device, generator=g)
    keys = bits.view(getattr(torch, key))
    if payload == "keys":
        return keys, None
    if payload == "rank":
        return keys, torch.arange(n, dtype=torch.int32, device=device).view(torch.uint32)
    return keys, torch.randint(-2**62, 2**62, (n,), dtype=torch.int64, device=device,
                               generator=g)


def runner(method: str, payload: str, check_order: bool = False):
    """The call a row times: ``sort`` with the row's engine and options."""
    kw = dict(method=method, check_order=check_order,
              values_are_ranks=payload == "rank")

    def run(k, v):
        return sort(k, **kw) if v is None else sort(k, v, **kw)
    return run


def _bits(t: torch.Tensor) -> np.ndarray:
    return interop.to_numpy(t.contiguous().view(torch.uint8))


def check(device="cuda", sizes=CHECK_SIZES) -> int:
    """Both engines give the same bytes for every key dtype, payload and
    size of `sizes`. Raises on a difference; returns 0."""
    dev = interop.resolve_device(device)
    for key in KEYS:
        for payload in PAYLOADS:
            for n in sizes:
                k, v = inputs(key, payload, n, dev)
                a, b = (runner(m, payload)(k, v) for m in ENGINES)
                a, b = ((a,), (b,)) if v is None else (a, b)
                if not all(np.array_equal(_bits(x), _bits(y)) for x, y in zip(a, b)):
                    raise AssertionError(f"engines differ: {key} {payload} n={n}")
    return 0


def time_row(key: str, payload: str, n: int, dev, check_order: bool = False,
             repeat: int = 1) -> dict:
    """One row: each engine's ms a call back to back (the median of
    `repeat` timings) and below ONESHOT_BELOW its synchronous wall time."""
    k, v = inputs(key, payload, n, dev)
    iters = 10 if n >= 1 << 22 else 20
    row = {"key": key, "payload": payload, "n": n, "check_order": check_order}
    for m in ENGINES:
        fn = runner(m, payload, check_order)
        row[f"{m}_ms"] = float(np.median(
            [device_time(fn, k, v, iters=iters) for _ in range(repeat)])) * 1e3
        if n < ONESHOT_BELOW:
            row[f"{m}_wall_ms"] = oneshot_time(fn, k, v) * 1e3
    del k, v
    torch.cuda.empty_cache()
    return row


def threshold(rows, key: str):
    """The smallest measured n from which radix is faster than bitonic in
    every row of `key` at that n and above (all payloads, with and without
    `check_order`), back to back and, where measured, in synchronous wall
    time; None if radix loses at the largest size."""
    rows = [r for r in rows if r["key"] == key]
    best = None
    for n in sorted({r["n"] for r in rows}, reverse=True):
        if any(not r[f"radix_{col}"] < r[f"bitonic_{col}"]
               for r in rows if r["n"] == n for col in ("ms", "wall_ms") if f"radix_{col}" in r):
            break
        best = n
    return best


def _cols(r, col):
    b, x = r.get(f"bitonic_{col}"), r.get(f"radix_{col}")
    return f"{b:9.4f} {x:9.4f}" if x is not None else " " * 19


def main(device="cuda", sizes=SIZES, keys=KEYS, repeat=1, check_order_sizes=None,
         json_path=None) -> list[dict]:
    """Time every key dtype, payload and size of `sizes`, then, for the 16-
    and 32-bit keys among `keys`, ``check_order=True`` on unsorted input at
    `check_order_sizes` (default: u32 key + rank at the largest size);
    print the table and each threshold; a row each."""
    dev = interop.resolve_device(device)
    rows = []
    print(f"{'key':>8} {'payload':>7} {'n':>10} | {'bitonic':>9} {'radix':>9} {'b/r':>6} | "
          f"{'wall b':>9} {'wall r':>9}")

    def run(key, payload, n, check_order):
        r = time_row(key, payload, n, dev, check_order=check_order, repeat=repeat)
        rows.append(r)
        print(f"{key:>8} {payload:>7} {n:>10}{' check_order' if check_order else ''} | "
              f"{_cols(r, 'ms')} {r['bitonic_ms'] / r['radix_ms']:6.2f} | "
              f"{_cols(r, 'wall_ms')}", flush=True)

    for key in keys:
        for payload in PAYLOADS:
            for n in sizes:
                run(key, payload, n, False)
    if check_order_sizes is None:
        run("uint32", "rank", max(sizes), True)
    else:
        for key in (k for k in keys if k != "uint64"):
            for payload in PAYLOADS:
                for n in check_order_sizes:
                    run(key, payload, n, True)
    for key in keys:
        print(f"threshold {key}: {threshold(rows, key)}")
    if json_path:
        with open(json_path, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write the rows to this file")
    ap.add_argument("--keys", nargs="+", default=KEYS, choices=KEYS)
    ap.add_argument("--exps", type=int, nargs=2, default=(10, 26), metavar=("LO", "HI"),
                    help="sizes 2^LO..2^HI and 3 * 2^k between (default 10 26; "
                    "none if LO > HI)")
    ap.add_argument("--repeat", type=int, default=1, help="timings a point, median")
    ap.add_argument("--check-order-exps", type=int, nargs=2, default=None,
                    metavar=("LO", "HI"), help="sizes of the check_order rows, as --exps "
                    "(default: u32 key + rank at the largest size)")
    a = ap.parse_args()

    def span(lo, hi):
        return tuple(n for n in SIZES_ALL if 1 << lo <= n <= 1 << hi)

    check()
    main(sizes=span(*a.exps), keys=tuple(a.keys), repeat=a.repeat,
         check_order_sizes=a.check_order_exps and span(*a.check_order_exps),
         json_path=a.json)
