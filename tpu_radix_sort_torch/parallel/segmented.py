"""Distributed segmented (ragged) sorts over a mesh axis.

Counterpart of ``tpu_radix_sort/parallel/segmented.py``. The segments are
given by `offsets`, replicated on every rank, over the global array whose
shard each rank holds. Two subsystems compose, with no new kind of
collective:

- segment ids and starts: each rank scatters only the boundaries of
  `offsets` that fall in its global range, and the distributed prefix sum
  (``parallel/scan.py``) scans them across the axis;
- the composite (segment, key, idx) tuple then goes through the
  compare-split network (``mesh_sort._shard_sort``) in the padded layout:
  the segment id leads the compare, so no element leaves its segment.

Narrow keys with seg_bits + bit_count <= 32 pack the segment id above the
key in one u32 column (the packing rule of JAX ``ops/segmented.py``), so
the common case moves no more bytes than a flat sort.
"""
from __future__ import annotations

import torch

from ..ops import common
from . import comm, layout
from .mesh_sort import _shard_sort, sort_in_layout
from .scan import mesh_scan


def _mesh_segment_ids_and_starts(offsets, lengths, group, *, need_starts):
    """(segment id, segment start) of each element of this rank's shard, as
    int32 (u32) columns: the boundaries of `offsets` in this rank's global
    range scattered (a 1 for the id, offsets[i] - offsets[i-1] for the
    start) and scanned inclusively across the axis. Boundaries at or past
    the end of the global array (trailing empty segments) fall in no range."""
    me = comm.axis_index(group)
    lo, n = sum(lengths[:me]), lengths[me]
    total = sum(lengths)
    b = offsets[1:-1]
    mine = ((b >= lo) & (b < lo + n)).to(torch.int32)
    at = (b - lo).clamp(0, max(n - 1, 0))
    dev = offsets.device

    def scanned(vals):
        col = torch.zeros(n, dtype=torch.int32, device=dev)
        if n:
            col.index_add_(0, at, vals * mine)
        return mesh_scan(col, group, lengths, total, inclusive=True)

    seg = scanned(torch.ones_like(mine))
    if not need_starts:
        return seg, None
    return seg, scanned((offsets[1:-1] - offsets[:-2]).to(torch.int32))


def mesh_sort_segments(keys, offsets, values=None, *, mesh, axis_name="x", bit_count,
                       descending=False, total_order=False, make_ranks=False, tile=None):
    """Distributed core of ``sort_segments(mesh=)`` / ``argsort_segments(mesh=)``.

    `keys` (and `values`) are this rank's shard; `offsets` (int64, on the
    keys' device) the global CSR bounds. The caller has validated the
    arguments and resolved `bit_count`. Returns (keys, the values, or the
    uint32 ranks when `make_ranks`, or None), this rank's shard of each.
    """
    group, n_dev, me = common.mesh_axis(mesh, axis_name)
    if n_dev & (n_dev - 1):
        raise ValueError(f"the segmented mesh sort runs the compare-split network, which "
                         f"needs a power-of-two axis size, got {n_dev}")
    lengths = layout.shard_lengths(keys.shape[0], group, keys.device)
    n = sum(lengths)
    S = offsets.shape[0] - 1
    if n <= 1:
        if make_ranks:
            return keys.clone(), torch.zeros(keys.shape[0], dtype=torch.uint32,
                                             device=keys.device)
        return keys.clone(), None if values is None else values.clone()

    full, mk, masked = common.order_cols(keys, bit_count, total_order=total_order,
                                         descending=descending)
    wide = common.is_64bit_key_dtype(keys.dtype)
    # the id packs above the masked key bits, never beside a 64-bit pair
    key_width = 32 if wide else bit_count
    seg, starts = _mesh_segment_ids_and_starts(offsets, lengths, group,
                                               need_starts=make_ranks)
    seg_bits = max(1, (S - 1).bit_length())
    packed = not wide and seg_bits + key_width <= 32
    if packed:
        key_cols = ((seg.to(torch.int64) << key_width | mk[0]).to(torch.int32),)
    else:
        key_cols = (seg, *mk)
    carry_full = masked or descending
    if make_ranks:
        lo = sum(lengths[:me])
        vcols = (torch.arange(lo, lo + keys.shape[0], dtype=torch.int32,
                              device=keys.device) - starts,)
    elif values is not None:
        vcols = common.values_to_u32_cols(values)
    else:
        vcols = ()
    payloads = (tuple(full) if carry_full else ()) + tuple(vcols)
    fills = [common.SENTINEL_U32] * (len(payloads) - len(vcols)) + [0] * len(vcols)
    lay = layout.Layout(group, lengths, n, layout.padded_length(n, n_dev))
    s_keys, s_pay = sort_in_layout(
        key_cols, payloads, fills, group=group, lay=lay,
        body=lambda x, nk: _shard_sort(x, nk, group, tile=tile))
    if carry_full:
        sorted_cols = s_pay[:len(full)]
    elif packed:
        # an unmasked ascending key under the id: its bits come back out
        sorted_cols = (s_keys[0] & common.i32(common.bit_mask(key_width)),)
    else:
        # unmasked ascending: the key columns follow the id's
        sorted_cols = s_keys[1:1 + len(full)]
    out_keys = common.from_order_cols(tuple(sorted_cols), keys.dtype,
                                      total_order=total_order)
    v_sorted = tuple(s_pay[len(s_pay) - len(vcols):])
    if make_ranks:
        return out_keys, v_sorted[0].contiguous().view(torch.uint32)
    if values is None:
        return out_keys, None
    return out_keys, common.values_from_u32_cols(v_sorted, values.dtype)
