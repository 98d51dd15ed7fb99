"""Tile choice for the bitonic kernels, budgeted against shared memory.

Counterpart of ``tpu_radix_sort/utils/dispatch.py``, which budgets a tile
against the TPU's VMEM. Here one CUDA block sorts one tile of `T` elements of
every co-sorted u32 column in shared memory, so ``n_arrays * T * 4`` bytes
must fit the 227 KB a Hopper block may use. A larger tile leaves fewer
strides that must run as whole-array passes through device memory.
"""
from __future__ import annotations

from ..ops import common

# Hopper's per-block limit of dynamic shared memory (232,448 bytes); above
# 48 KB a kernel needs cudaFuncAttributeMaxDynamicSharedMemorySize.
SMEM_BUDGET_BYTES = 227 * 1024


def choose_tile(n_pad: int, n_arrays: int, budget: int = SMEM_BUDGET_BYTES) -> int:
    """Largest power-of-two tile (elements) with ``n_arrays * T * 4 <= budget``,
    and no longer than the padded array."""
    t = 1
    while 2 * t * n_arrays * 4 <= budget:
        t *= 2
    return min(t, common.next_pow2(n_pad))
