"""Demo: the card's sort against the native CPU baseline.

Counterpart of ``examples/demo.py``, the CLI port of the reference's browser
demo: the same knobs (element count, bit count, keys or keys + values, the
order check, consecutive sorts) as flags, the same output (device time, CPU
time, speedup) as a printed table, and the same initial data (random or
sorted, from ``--seed``).

Usage:
    python -m tpu_radix_sort_torch.examples.demo --n 4194304 --values --consecutive 4
    python -m tpu_radix_sort_torch.examples.demo --n 1000000 --sorted --check-order
    python -m tpu_radix_sort_torch.examples.demo --n 5000 --device cpu

On the card the sort's time is ``runtime.timing.device_time`` (CUDA events);
with ``--device cpu`` it is host wall time (``perf_counter``), labelled so.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import tpu_radix_sort_torch as trt
from tpu_radix_sort_torch.runtime.cpu_baseline import cpu_sort, sort_kind
from tpu_radix_sort_torch.runtime.timing import device_time
from tpu_radix_sort_torch.utils import interop

PACKED_WIDTHS = (8192, 4096, 1024, 128, 1)  # the reference's texture widths
HOST_REPS = 3  # host wall time: the median of this many calls


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=1 << 22,
                   help="element count (reference slider: 1e4..2^24)")
    p.add_argument("--bit-count", type=int, default=None,
                   help="bits to sort on, multiple of 4 (default: the key width, 32, "
                        "or 64 with --dtype uint64)")
    p.add_argument("--values", action="store_true",
                   help="sort key+value pairs (default keys-only)")
    p.add_argument("--ranks", action="store_true",
                   help="promise values are strictly-increasing ranks (argsort "
                        "payload): 2-column fast path")
    p.add_argument("--sorted", action="store_true", dest="presorted",
                   help="initial data already sorted (reference 'Sorted' mode)")
    p.add_argument("--check-order", action="store_true",
                   help="enable the order-check early exit")
    p.add_argument("--consecutive", type=int, default=1,
                   help="number of consecutive sorts, each re-sorting the previous "
                        "frame's output: with --check-order, frames 2+ hit the early exit")
    p.add_argument("--method", default="auto", choices=["auto", "bitonic", "radix", "xla"])
    p.add_argument("--tile", type=int, default=None,
                   help="elements a CUDA block sorts (a power of two; the reference's "
                        "workgroup-size slider); default: the largest that fits shared "
                        "memory")
    p.add_argument("--block-rows", type=int, default=None,
                   help="the JAX package's tile height: accepted and passed on, and the "
                        "port's entry points ignore it")
    p.add_argument("--packed", action="store_true",
                   help="sort packed (key, value) records in a 2-D layout (the "
                        "reference's texture-mode runner)")
    p.add_argument("--dtype", default="uint32", choices=["uint32", "uint64"],
                   help="key dtype; uint64 runs the functional sort() path")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--seed", type=int, default=0)
    return p


def make_keys(n: int, seed: int, wide: bool, presorted: bool) -> np.ndarray:
    """The demo's keys, as the JAX demo makes them from the seed."""
    rng = np.random.default_rng(seed)
    if wide:
        keys = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    else:
        keys = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.sort(keys) if presorted else keys


def packed_width(n: int) -> int:
    return next(w for w in PACKED_WIDTHS if n % w == 0)


def _numpy(out):
    if isinstance(out, tuple):
        return tuple(interop.to_numpy(o) for o in out)
    return interop.to_numpy(out)


def _timer(dev):
    """Seconds a call of fn(*args): the card's time, or host wall time."""
    if dev.type == "cuda":
        return device_time

    def host_time(fn, *args):
        ts = []
        for _ in range(HOST_REPS):
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))
    return host_time


def main(argv=None) -> dict:
    """Run the demo; print its table and return its inputs, outputs and
    times: ``keys`` (and ``packed``) as numpy, ``out`` (frame 1's result),
    ``fed_out`` (a later frame's result, with --consecutive > 1), ``t_dev``,
    ``t_rest``, ``t_cpu`` in seconds, ``cpu_kind`` and ``timer``."""
    p = parser()
    args = p.parse_args(argv)
    if args.packed and args.values:
        p.error("--packed implies key+value records; drop --values")
    if args.ranks and args.consecutive > 1:
        p.error("--ranks with --consecutive > 1: frames 2+ feed the sorted "
                "permutation back as values, which violates the "
                "strictly-increasing rank promise")
    wide = args.dtype == "uint64"
    if wide and args.packed:
        p.error("--packed records are u32 pairs; --dtype uint64 unsupported")
    if args.bit_count is None:
        args.bit_count = 64 if wide else 32
    dev = interop.resolve_device(args.device)
    timer_name = "device" if dev.type == "cuda" else "host wall"
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")

    keys_np = make_keys(args.n, args.seed, wide, args.presorted)
    keys = interop.from_numpy(keys_np, dev)
    values_np = np.arange(args.n, dtype=np.uint32)
    values = interop.from_numpy(values_np, dev) if args.values else None
    opts = dict(bit_count=args.bit_count, check_order=args.check_order, method=args.method,
                tile=args.tile, block_rows=args.block_rows)
    result = {"keys": keys_np, "timer": timer_name}
    if wide:
        def step(k, v=None):
            return trt.sort(k, v, values_are_ranks=args.ranks, **opts)
    elif args.packed:
        w = packed_width(args.n)
        packed_np = np.stack([keys_np, values_np], axis=-1).reshape(args.n // w, w, 2)
        result["packed"] = packed_np
        kern = trt.RadixSortPackedKernel(count=args.n, device=dev, **opts)
        step = kern.dispatch
    else:
        kern = trt.RadixSortKernel(count=args.n, has_values=args.values,
                                   values_are_ranks=args.ranks, device=dev, **opts)
        step = kern.dispatch
    if args.packed:
        x = (interop.from_numpy(packed_np, dev),)
    else:
        x = (keys, values) if args.values else (keys,)

    t0 = time.perf_counter()
    out = step(*x)
    result["out"] = _numpy(out)
    print(f"build+first run: {time.perf_counter() - t0:.1f}s")

    timer = _timer(dev)
    t_dev = timer(step, *x)
    # consecutive mode: every frame after the first re-sorts the previous
    # frame's output, an already sorted buffer; with --check-order the cost
    # of frames 2+ collapses to the early-exit gate. They all see the same
    # sorted input, so one more timing on the fed-back state prices them.
    t_rest = None
    if args.consecutive > 1:
        fed = out if isinstance(out, tuple) else (out,)
        result["fed_out"] = _numpy(step(*fed))
        t_rest = timer(step, *fed)

    # the CPU baseline: the native C++ radix sort, u32 only, so 64-bit keys
    # take NumPy's sort
    t0 = time.perf_counter()
    if wide:
        np.argsort(keys_np, kind="stable") if args.values else np.sort(keys_np)
    elif args.values or args.packed:
        cpu_sort(keys_np, values_np)
    else:
        cpu_sort(keys_np)
    t_cpu = time.perf_counter() - t0
    cpu_kind = "numpy" if wide else sort_kind()

    kind = "packed records" if args.packed else ("key+value" if args.values else "keys-only")
    label = "card" if dev.type == "cuda" else "host wall (not a device time)"
    print(f"\n  n={args.n:,}  {kind} {args.dtype}  bit_count={args.bit_count}"
          f"  check_order={args.check_order}  method={args.method}  tile={args.tile}")
    t_sort = t_dev
    if t_rest is not None:
        for fr in range(1, args.consecutive + 1):
            t_fr = t_dev if fr == 1 else t_rest
            note = "" if fr == 1 else "  (re-sorts previous output)"
            print(f"  frame {fr:2d}: {t_fr * 1e3:9.3f} ms   {args.n / t_fr / 1e9:7.3f} "
                  f"Gkeys/s{note}")
        t_sort = (t_dev + (args.consecutive - 1) * t_rest) / args.consecutive
        print(f"  {label} avg over {args.consecutive} consecutive sorts: "
              f"{t_sort * 1e3:9.3f} ms")
    else:
        print(f"  {label}:  {t_dev * 1e3:9.3f} ms   {args.n / t_dev / 1e9:7.3f} Gkeys/s")
    print(f"  CPU:  {t_cpu * 1e3:9.3f} ms   ({cpu_kind})")
    print(f"  speedup: {t_cpu / t_sort:.1f}x")
    result.update(t_dev=t_dev, t_rest=t_rest, t_sort=t_sort, t_cpu=t_cpu, cpu_kind=cpu_kind)
    return result


if __name__ == "__main__":
    main()
