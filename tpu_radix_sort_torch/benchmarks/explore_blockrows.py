"""Sweep the bitonic network's tile against ``choose_tile``'s pick.

Counterpart of ``benchmarks/explore_blockrows.py``, which sweeps the TPU
engine's tile height against ``choose_block_rows`` (a VMEM budget). Here
the tile is the elements one CUDA block sorts in shared memory, and
``utils/dispatch.py`` ``choose_tile`` takes the largest power of two whose
columns fit 227 KB. At 2^24:

- ``bitonic.sort_padded((k, tie, *pads), stable=True, tile=t)`` with 3
  columns over tiles 2,048-16,384 and with 6 over 1,024-8,192 (the pads
  equal to the tie, so that one check covers every column);
- the headline A/B: ``sort(k, v, values_are_ranks=True, tile=t)`` (2
  columns) and keys-only ``sort(k, tile=t)`` (1 column, up to 32,768).

Only tiles whose ``columns * t * 4`` bytes fit ``SMEM_BUDGET_BYTES`` are
listed; no row fails soft. Each row is marked where it is the tile that
``choose_tile`` picks (``bitonic.resolve_tile``) and where it is the
fastest of its sweep. ``main``'s `n`, `headline` and `sweep` take the
place of the JAX script's BLOCKROWS_N / BLOCKROWS_HEADLINE environment.

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.explore_blockrows``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import bitonic
from ..ops.sort import sort
from ..runtime.timing import device_time
from ..utils import dispatch, interop

N = 1 << 24
# (sweep, columns, candidate tiles)
SWEEPS = (("sort_padded", 3, (2048, 4096, 8192, 16384)),
          ("sort_padded", 6, (1024, 2048, 4096, 8192)),
          ("sort key+rank", 2, (2048, 4096, 8192, 16384, 32768)),
          ("sort keys-only", 1, (2048, 4096, 8192, 16384, 32768)))


def tiles(n_arr: int, candidates) -> list[int]:
    """The candidates whose columns fit the shared-memory budget."""
    return [t for t in candidates if n_arr * t * 4 <= dispatch.SMEM_BUDGET_BYTES]


def inputs(n: int, seed: int, device):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return keys, interop.from_numpy(keys, device), torch.arange(
        n, dtype=torch.int32, device=interop.resolve_device(device)).view(torch.uint32)


def sweep_fn(sweep: str, n_arr: int, tile: int, tie: torch.Tensor):
    """The call of one row: keys -> its output tuple."""
    if sweep == "sort_padded":
        pads = (tie,) * (n_arr - 2)
        return lambda k: bitonic.sort_padded((k, tie, *pads), stable=True, tile=tile)
    if sweep == "sort key+rank":
        return lambda k: sort(k, tie, values_are_ranks=True, tile=tile)
    return lambda k: (sort(k, tile=tile),)


def _ok(out, ref, perm) -> bool:
    """Keys sorted; every other column the input's iota moved with them."""
    got = [interop.to_numpy(o) for o in out]
    return np.array_equal(got[0], ref) and all(np.array_equal(c, perm) for c in got[1:])


def check(device="cuda", n=N, seed=0, sweeps=SWEEPS) -> int:
    """Every row's output byte for byte: keys against ``np.sort``, the tie,
    pads and ranks against the stable order. Raises; returns 0."""
    keys, k, tie = inputs(n, seed, device)
    perm = np.argsort(keys, kind="stable").astype(np.uint32)
    ref = keys[perm]
    for sweep, n_arr, cand in sweeps:
        for t in tiles(n_arr, cand):
            if not _ok(sweep_fn(sweep, n_arr, t, tie)(k), ref, perm):
                raise AssertionError(f"{sweep}, {n_arr} columns, tile {t} differs")
    return 0


def main(device="cuda", n=N, seed=0, headline=True, sweep=True) -> list[dict]:
    """Time the rows of the padded sweeps (`sweep`) and of the headline
    A/B (`headline`); print and return a row each."""
    keys, k, tie = inputs(n, seed, device)
    out = []
    for name, n_arr, cand in SWEEPS:
        if not (sweep if name == "sort_padded" else headline):
            continue
        chosen = bitonic.resolve_tile(n, n_arr)  # the default call's tile
        rows = [{"probe": "explore_blockrows", "sweep": name, "columns": n_arr, "n": n,
                 "tile": t, "chosen": t == chosen,
                 "ms": device_time(sweep_fn(name, n_arr, t, tie), k) * 1e3}
                for t in tiles(n_arr, cand)]
        best = min(rows, key=lambda r: r["ms"])
        for r in rows:
            r["fastest"] = r is best
            marks = " <- choose_tile" * r["chosen"] + " <- fastest" * r["fastest"]
            print(f"{name:15s} {n_arr} col  tile {r['tile']:6d}  {r['ms']:9.3f} ms  "
                  f"{n / r['ms'] / 1e3:7.1f} Mkeys/s{marks}", flush=True)
        out += rows
    return out


if __name__ == "__main__":
    check()
    main()
