"""K1's tile kernel taken apart: loads and stores, register stages, window
changes, direction handling, and the global stage.

Counterpart of ``benchmarks/explore_stages.py``, which times variants of the
TPU kernel's compare-exchange (sublane and lane rolls, a dynamic k, the
slicing formulation, a TPU dead end not carried over) in one call over
2^24 elements. Here each case is one or more calls of the port's own K1
(``csrc/bitonic.cu`` through ``ops/bitonic.py``) at 2^24, tile 16,384
(a chunk of 2^14 elements a block, windows 0 and 5-9):

- ``zero``: ``tile_stages`` with no stage, beside a ``copy_`` of the same
  columns: the load and store floor;
- ``one_window``: 16 stages with strides on index bits 5-9, all in window
  5 (no change of window), each stage (k, j) with k = 2j: the direction
  changes inside the chunk;
- ``window_change``: 16 stages whose strides alternate between bits 0-4
  (window 0) and bits 10-13 (window 9), k = 2j: a change of window every
  stage, through shared memory;
- ``one_window_k_above``, ``window_change_k_above``: the same stages with
  k = 2^20, above the tile: the direction comes from the global index, as
  in a merge tail;
- ``global``: 16 ``global_stage`` calls, strides on bits 14-23, k = 2j.

Each case runs on 1 column (``n_keys=1``) and on 3 (key, a unique tie,
a payload; ``n_keys=2``). Every timed call gets its own copy of the same
random input, so that no call sees the order an earlier one left. Printed:
ms, us a stage ((t16 - t0) / 16, t0 the ``zero`` case), element-stages a
second, and the bound: the columns read and written once at
``HBM_BYTES_PER_S``, or the stages' operations at ``ALU_OPS_PER_S``.

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.explore_stages``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import bitonic
from ..runtime import timing
from ..runtime.timing import device_time
from ..utils import interop
from . import ALU_OPS_PER_S, HBM_BYTES_PER_S

N = 1 << 24
TILE = 1 << 14
STAGES = 16
K_ABOVE = 1 << 20
COLUMNS = ((1, 1), (3, 2))  # (columns, key words)
CASES = ("zero", "one_window", "window_change", "one_window_k_above",
         "window_change_k_above", "global")
ITERS = 10  # timed calls of a case (each on its own copy of the input)


def case_stages(case: str, tile: int = TILE, n: int = N) -> list[tuple[int, int]]:
    """The (k, j) stages of a case, for a tile of `tile` (a chunk of 2^L
    elements, L >= 10) and `n` elements: the window cases on the chunk's
    bits (0-4, 5-9 and L-4..L-1), the global case on bits L..log2(n)-1."""
    L = bitonic.chunk_bits(tile)
    if case == "zero":
        return []
    if case.startswith("one_window"):
        js = [1 << (5 + i % 5) for i in range(STAGES)]
    elif case.startswith("window_change"):
        js = [1 << (i // 2 % 5 if i % 2 == 0 else L - 4 + i // 2 % 4) for i in range(STAGES)]
    elif case == "global":
        top = n.bit_length() - 1
        js = [1 << (L + i % (top - L)) for i in range(STAGES)]
    else:
        raise ValueError(f"unknown case {case!r}")
    above = case.endswith("k_above")
    return [(K_ABOVE if above else 2 * j, j) for j in js]


def run_case(x: torch.Tensor, case: str, n_keys: int, tile: int = TILE) -> torch.Tensor:
    """The case's K1 calls on the (n_arr, n) int32 columns x, in place."""
    stages = case_stages(case, tile, x.shape[1])
    if case == "global":
        for k, j in stages:
            bitonic.global_stage(x, k, j, n_keys=n_keys)
        return x
    return bitonic.tile_stages(x, stages, n_keys=n_keys, tile=tile)


def inputs(n_arr: int, n: int, seed: int, device) -> torch.Tensor:
    """Columns (key, unique tie, payload)[:n_arr] as one (n_arr, n) int32
    tensor of u32 patterns, from the seed."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            rng.permutation(n).astype(np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)][:n_arr]
    return interop.from_numpy(np.stack(cols).view(np.int32), device)


def ops_per_pair(n_arr: int, n_keys: int, case: str) -> int:
    """32-bit integer operations a compare-exchange needs: one key word, a
    minimum and a maximum (2); two key words, a two-word compare and a
    select of each word of each side (6); the global stage also swaps each
    payload column (2 a column)."""
    ops = 2 if n_keys == 1 else 2 + 2 * n_keys
    return ops + (2 * (n_arr - n_keys) if case == "global" else 0)


def bound_ms(case: str, n_arr: int, n_keys: int, n: int = N) -> tuple[float, str]:
    """The case's least time: every tile call reads and writes every column
    once; the global stages read every column once each (their writes
    depend on the data and are not counted); or the stages' operations."""
    stages = len(case_stages(case, TILE, n))
    n_bytes = (stages if case == "global" else 2) * n_arr * 4 * n
    n_ops = stages * n // 2 * ops_per_pair(n_arr, n_keys, case)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_fresh(fn, x0: torch.Tensor, iters: int = ITERS) -> float:
    """Mean ms of fn(y) with each call on its own copy y of x0, queued
    behind a sleep (``device_time(queued=True)``)."""
    ring = iter([x0.clone() for _ in range(1 + iters * timing.QUEUE_TRIES)])
    ms = device_time(lambda _: fn(next(ring)), x0, warmup=1, iters=iters, queued=True) * 1e3
    del ring
    torch.cuda.empty_cache()
    return ms


def check(device="cuda", seed=0, n=N, tile=TILE) -> int:
    """Every case and column count against ``stages_plain`` on the same
    input, byte for byte. Raises on a difference; returns 0."""
    dev = interop.resolve_device(device)
    for n_arr, n_keys in COLUMNS:
        x0 = inputs(n_arr, n, seed + n_arr, dev)
        for case in CASES:
            got = run_case(x0.clone(), case, n_keys, tile)
            want = bitonic.stages_plain(x0.clone(), case_stages(case, tile, n), n_keys)
            if not torch.equal(got, want):
                raise AssertionError(f"K1 {case}, {n_arr} columns differs from stages_plain")
    return 0


def main(device="cuda", seed=0, n=N) -> list[dict]:
    """Time every case and column count; print and return a row each."""
    dev = interop.resolve_device(device)
    rows = []
    for n_arr, n_keys in COLUMNS:
        x0 = inputs(n_arr, n, seed + n_arr, dev)
        out = torch.empty_like(x0)
        copy_ms = device_time(lambda a: out.copy_(a), x0, queued=True) * 1e3
        del out
        t0 = None
        for case in CASES:
            ms = time_fresh(lambda y, case=case: run_case(y, case, n_keys), x0)
            t0 = ms if case == "zero" else t0
            b_ms, b_by = bound_ms(case, n_arr, n_keys, n)
            row = {"probe": "explore_stages", "case": case, "columns": n_arr,
                   "key_words": n_keys, "n": n, "tile": TILE, "ms": ms,
                   "bound_ms": b_ms, "bound_by": b_by}
            if case == "zero":
                row["copy_ms"] = copy_ms
                line = f"copy_ {copy_ms:8.4f} ms"
            else:
                us = (ms - t0) * 1e3 / STAGES
                row.update(us_per_stage=us, gelem_stages_per_s=n / us / 1e3)
                line = f"{us:7.2f} us/stage  {n / us / 1e3:7.1f} Gelem-stages/s"
            print(f"K1 {case:22s} {n_arr} col  {ms:8.4f} ms  {line}  bound {b_ms:.4f} ms "
                  f"({b_by})", flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    check()
    main()
