"""Distributed order checks: the early-exit gate of the mesh sorts and the
public ``is_sorted`` / ``disorder_count`` over a mesh.

Counterpart of ``tpu_radix_sort/parallel/check.py``. Each rank counts the
adjacent descents of its own shard with K2 (one column) or K3 (the (hi, lo)
pair of 64-bit keys) through ``ops/checksort.py``; the pairs between
neighbouring shards are covered by ONE ``all_gather`` of each shard's
(descents, non-empty, first row, last row), which also sums the verdicts.
JAX shifts each shard's first element left with a ``ppermute``; a shift
cannot skip an empty shard (n < D, uneven shards), a gather of the edges
can, so each boundary pair joins the last row of a non-empty shard to the
first row of the next non-empty one.
"""
from __future__ import annotations

import torch

from ..ops import checksort, common
from ..utils import interop
from . import comm, layout

_U32 = 0xFFFFFFFF


def _edges_and_verdict(cols, bad: torch.Tensor, group) -> int:
    """Total over the axis of every rank's `bad` (a 1-element int tensor)
    plus the descents between neighbouring non-empty shards, one gather."""
    nc = len(cols)
    n = cols[0].shape[0]
    dev = cols[0].device
    row = torch.zeros(2 + 2 * nc, dtype=torch.int64, device=dev)
    row[0] = bad.to(torch.int64).reshape(())
    if n:
        row[1] = 1
        for c, col in enumerate(cols):
            row[2 + c] = col[0].to(torch.int64) & _U32
            row[2 + nc + c] = col[-1].to(torch.int64) & _U32
    rows = comm.all_gather(row, group).tolist()
    total = sum(r[0] for r in rows)
    last = None
    for r in rows:
        if not r[1]:
            continue
        if last is not None and tuple(last) > tuple(r[2:2 + nc]):
            total += 1
        last = r[2 + nc:]
    return total


def global_is_sorted(cols, group) -> bool:
    """Whether the sharded column tuple (1 or 2 int32 columns, compared
    lexicographically as u32) is sorted across the axis; the same verdict
    on every rank. Each rank runs the fast-gated local check."""
    ok = checksort.is_sorted_cols(tuple(cols)) if cols[0].shape[0] else True
    bad = torch.tensor([0 if ok else 1], dtype=torch.int64, device=cols[0].device)
    return _edges_and_verdict(cols, bad, group) == 0


def _check_view(u, *, mesh, axis_name, count, bit_count, total_order, descending,
                device):
    """This shard's key view as the sort with these options orders it, with
    the elements at global index >= count turned into 0xFFFFFFFF (JAX
    ``check.py:96,213``: an all-max tail adds no descent). Returns
    (group, columns, global count)."""
    group, _, me = common.mesh_axis(mesh, axis_name)
    u = interop.as_tensor(u, device)
    if u.dim() != 1:
        raise ValueError("keys must be 1-D")
    common.check_key_dtype(u.dtype)
    bit_count = common.native_key_bits(u.dtype) if bit_count is None else bit_count
    common.validate_bit_count_for(u.dtype, bit_count)
    lengths = layout.shard_lengths(u.shape[0], group, u.device)
    n = sum(lengths)
    count = n if count is None else int(count)
    if not 0 <= count <= n:
        raise ValueError(f"count {count} out of range for buffer of {n}")
    u = u.contiguous()
    if common.is_64bit_key_dtype(u.dtype):
        cols = checksort._as_check_key_cols(u, bit_count, total_order=total_order,
                                            descending=descending)
    else:
        cols = (checksort._as_check_key(u, bit_count, total_order=total_order,
                                        descending=descending),)
    real = max(0, min(u.shape[0], count - sum(lengths[:me])))
    if real < u.shape[0]:
        cols = tuple(torch.cat([c[:real], torch.full((u.shape[0] - real,), -1,
                                                     dtype=torch.int32, device=c.device)])
                     for c in cols)
    return group, cols, count


def mesh_disorder_count(u, *, mesh, axis_name="x", count=None, bit_count=None,
                        total_order=False, descending=False, block_rows=None,
                        interpret=None, device=None) -> torch.Tensor:
    """Adjacent inversions in the first `count` keys of the global array
    (`count` global), as a 0-d uint32 tensor on this shard's device, the
    same on every rank. Same key-view options as ``disorder_count``."""
    del block_rows, interpret
    group, cols, count = _check_view(u, mesh=mesh, axis_name=axis_name, count=count,
                                     bit_count=bit_count, total_order=total_order,
                                     descending=descending, device=device)
    dev = cols[0].device
    if count < 2:
        return torch.zeros((), dtype=torch.int32, device=dev).view(torch.uint32)
    bad = checksort._disorder_cols(cols) if cols[0].shape[0] else torch.zeros(
        1, dtype=torch.int32, device=dev)
    total = _edges_and_verdict(cols, bad.to(torch.int64) & _U32, group)
    return torch.tensor(common.i32(total), dtype=torch.int32, device=dev).view(torch.uint32)


def mesh_is_sorted(u, *, mesh, axis_name="x", count=None, bit_count=None,
                   total_order=False, descending=False, block_rows=None,
                   interpret=None, device=None) -> bool:
    """Fast-gated order check of the first `count` keys of the global
    array, the same verdict on every rank (:func:`global_is_sorted`)."""
    del block_rows, interpret
    group, cols, count = _check_view(u, mesh=mesh, axis_name=axis_name, count=count,
                                     bit_count=bit_count, total_order=total_order,
                                     descending=descending, device=device)
    if count < 2:
        return True
    return global_is_sorted(cols, group)
