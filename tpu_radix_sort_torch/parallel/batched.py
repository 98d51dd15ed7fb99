"""Distributed batched (per-row) sorts over a mesh axis.

Counterpart of ``tpu_radix_sort/parallel/batched.py``. Rows are
independent, so the batch dimension is the one the axis shards and there
is no collective at all: each rank sorts its own block of rows through the
row-local network of ``ops/batched.py``. A rank with no rows returns an
empty block.
"""
from __future__ import annotations

from ..ops import batched as ops_batched
from ..ops import common


def mesh_sort_batched(keys, values=None, *, mesh, axis_name="x", bit_count,
                      descending=False, total_order=False, values_are_ranks=False,
                      method="bitonic", tile=None):
    """Distributed core of ``sort_batched(mesh=)``: this rank's (B_r, n)
    block of rows, sorted row by row. The caller has validated the
    arguments and resolved `bit_count` and `method`. Returns (keys,
    values_or_None)."""
    common.mesh_axis(mesh, axis_name)
    return ops_batched._sort_batched_core(
        keys, values, bit_count=bit_count, descending=descending, total_order=total_order,
        values_are_ranks=values_are_ranks, method=method, tile=tile)
