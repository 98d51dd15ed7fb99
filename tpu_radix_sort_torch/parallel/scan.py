"""Distributed prefix sum over a mesh axis.

Counterpart of ``tpu_radix_sort/parallel/scan.py``: each rank scans the
part of its shard that lies below the global `count` through K4
(``ops/scan.py`` ``scan_kernel``), ONE ``all_gather`` of the shard totals
gives the sum of the shards before it, and every rank adds that offset.
u32 wraparound addition is associative, so the fold is exact; int32 items
come back as int32 with the same wraparound. The elements from `count` on
are returned untouched.
"""
from __future__ import annotations

import torch

from ..ops import common, scan
from ..utils import interop
from . import comm, layout

_U32 = 0xFFFFFFFF


def mesh_scan(u: torch.Tensor, group, lengths, count: int, inclusive: bool) -> torch.Tensor:
    """Scan of a shard `u` (1-D int32, u32 patterns) of the global array
    whose shard lengths are `lengths`, over its first `count` elements."""
    me = comm.axis_index(group)
    a = max(0, min(u.shape[0], count - sum(lengths[:me])))
    head = u[:a].contiguous()
    total = torch.zeros(1, dtype=torch.int64, device=u.device)
    if a:
        head = scan.scan_kernel(head, inclusive=inclusive)
        total = head[-1:].to(torch.int64) & _U32
        if not inclusive:
            total = total + (u[a - 1:a].to(torch.int64) & _U32)
    totals = comm.all_gather(total, group).reshape(-1)
    offset = int(totals[:me].sum()) & _U32
    if offset and a:
        head = scan._wrap_i32(head.to(torch.int64) + offset)
    return torch.cat([head, u[a:]])


def mesh_prefix_sum(items, *, mesh, axis_name="x", count=None, inclusive=False,
                    block_rows=None, interpret=None, device=None):
    """Exclusive (default) or inclusive prefix sum of the first `count`
    elements of the global array (`count` global), u32 wraparound, the rest
    untouched: this rank's shard of the result, a new tensor of the items'
    dtype (uint32 or int32)."""
    del block_rows, interpret
    group, _, _ = common.mesh_axis(mesh, axis_name)
    items = interop.as_tensor(items, device)
    if items.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"prefix_sum expects uint32/int32, got {items.dtype}")
    if items.dim() != 1:
        raise ValueError("items must be 1-D")
    lengths = layout.shard_lengths(items.shape[0], group, items.device)
    n = sum(lengths)
    count = n if count is None else int(count)
    if not 0 <= count <= n:
        raise ValueError(f"count {count} out of range")
    if count == 0:
        return items.clone()
    out = mesh_scan(items.view(torch.int32).contiguous(), group, lengths, count, inclusive)
    return out.view(items.dtype)
