"""Segmented sorts: independently sort variable-length segments of a flat
tensor (the ragged generalisation of ``ops/batched.py``).

Counterpart of ``tpu_radix_sort/ops/segmented.py``. Segments are given
CSR-style by `offsets` (length S+1, offsets[0] == 0, offsets[-1] == n,
nondecreasing; empty segments allowed). The engine sorts the flat tensor
by the composite key (segment id, key) through the flat bitonic network
(``ops/sort.py`` ``_bitonic_pad_sort``, kernel K1): the segment id
dominates, so no element leaves its segment. The id packs into the key's
u32 word above the masked key bits when ceil(log2(S)) + bit_count <= 32
(one key column), and is a key column of its own otherwise: a 64-bit key
with `bit_count` above 32 compares (segment, hi, lo, tie), four key words.

Segment ids come from a scatter of a 1 at each interior boundary and an
inclusive scan (kernel K4, ``ops/scan.py``), and the segment starts, for
`argsort_segments`, from a scatter of the offset deltas and a second scan,
as in the JAX package, where a `searchsorted` was element-serial on the TPU.

`method='xla'` sorts with ``torch.sort(stable=True)``: the biased int32
view of one key column, the int64 word of two, and for (segment, hi, lo)
two stable passes, least significant first.
"""
from __future__ import annotations

import torch

from ..utils import interop
from . import common, scan
from . import sort as sort_mod


def _offsets(offsets, device) -> torch.Tensor:
    """`offsets` as an int64 tensor on `device`, checked as the JAX
    package checks it (the values are the caller's contract)."""
    offsets = interop.as_tensor(offsets, device)
    if offsets.dim() != 1 or offsets.shape[0] < 2:
        raise ValueError("offsets must be 1-D with length >= 2 (S+1 bounds)")
    if offsets.dtype.is_floating_point or offsets.dtype.is_complex or offsets.dtype == torch.bool:
        raise TypeError("offsets must be an integer array")
    return offsets.to(torch.int64)


def _keys(keys, device, name) -> torch.Tensor:
    keys = interop.as_tensor(keys, device)
    if keys.dim() != 1:
        raise ValueError(f"{name} expects a 1-D key array")
    return keys.contiguous()


def sort_segments(
    keys,
    offsets,
    values=None,
    *,
    bit_count: int | None = None,
    descending: bool = False,
    total_order: bool = False,
    values_are_ranks: bool = False,
    method: str = "auto",
    tile: int | None = None,
    block_rows=None,
    interpret=None,
    device=None,
    mesh=None,
    axis_name: str = "x",
):
    """Stable ascending sort of each segment ``[offsets[i], offsets[i+1])``
    of a flat 1-D key tensor, co-permuting optional 4- or 8-byte `values`.

    `offsets`: any 1-D integer array or tensor, length S+1 (see the module
    docstring); it goes to the keys' device. Same key-dtype and option
    surface as :func:`~.sort.sort`. `values_are_ranks=True` promises each
    SEGMENT of `values`, viewed as u32, is strictly increasing with every
    element < 0xFFFFFFFF. Returns keys or (keys, values), same shape, on
    the keys' device. `block_rows` and `interpret` are accepted and ignored.

    `mesh=` (a ``DeviceMesh``): `keys` (and `values`) are this rank's shard
    of the global arrays, `offsets` the global bounds, the same on every
    rank, and `method` 'auto' or 'mesh'; the result is this rank's shard
    (``parallel/segmented.py``; `values_are_ranks` is ignored there).
    """
    del block_rows, interpret
    keys = _keys(keys, device, "sort_segments")
    offsets = _offsets(offsets, keys.device)
    if values is not None:
        values = interop.as_tensor(values, keys.device).contiguous()
    if mesh is not None:
        _check_mesh_method(method, "sort_segments")
        method = "auto"
    bit_count, method = common.check_args(
        keys, values, bit_count=bit_count, values_are_ranks=values_are_ranks,
        method=method, name="sort_segments")
    if mesh is not None:
        from ..parallel.segmented import mesh_sort_segments

        out_k, out_v = mesh_sort_segments(
            keys, offsets, values, mesh=mesh, axis_name=axis_name, bit_count=bit_count,
            descending=descending, total_order=total_order, tile=tile)
        return out_k if values is None else (out_k, out_v)
    out_k, out_v = _sort_segments_core(
        keys, offsets, values, bit_count=bit_count, descending=descending,
        total_order=total_order, values_are_ranks=values_are_ranks and values is not None,
        make_ranks=False, method=method, tile=tile)
    return out_k if values is None else (out_k, out_v)


def argsort_segments(keys, offsets, *, bit_count=None, descending=False,
                     total_order=False, method="auto", tile=None, block_rows=None,
                     interpret=None, device=None, mesh=None, axis_name="x"):
    """Per-segment stable ranks (uint32): the position within its segment
    that each element sorts to. The payload, position minus segment start,
    satisfies the rank contract; the starts come from the same boundary
    scan as the segment ids. Arguments are checked as
    :func:`sort_segments` checks them, and `mesh=` runs as there."""
    del block_rows, interpret
    keys = _keys(keys, device, "argsort_segments")
    offsets = _offsets(offsets, keys.device)
    if mesh is not None:
        _check_mesh_method(method, "argsort_segments")
        method = "auto"
    bit_count, method = common.check_args(
        keys, None, bit_count=bit_count, values_are_ranks=True, method=method,
        name="argsort_segments")
    if mesh is not None:
        from ..parallel.segmented import mesh_sort_segments

        return mesh_sort_segments(
            keys, offsets, mesh=mesh, axis_name=axis_name, bit_count=bit_count,
            descending=descending, total_order=total_order, make_ranks=True, tile=tile)[1]
    return _sort_segments_core(
        keys, offsets, None, bit_count=bit_count, descending=descending,
        total_order=total_order, values_are_ranks=True, make_ranks=True,
        method=method, tile=tile)[1]


def _check_mesh_method(method, name):
    if method not in ("auto", "mesh"):
        raise ValueError(f"with mesh=, {name} supports method in ('auto', 'mesh'); "
                         f"got {method!r}")


def segment_ids_and_starts(offsets, n, *, need_starts):
    """Element position -> (segment id, segment start), int32 (u32) columns.

    - segment id: a 1 at each interior boundary, inclusive-scanned (K4):
      the count of boundaries <= i. Coincident boundaries (empty segments)
      add up; leading empty segments put their 1s at index 0.
    - segment start: offsets[i] - offsets[i-1] at boundary i, which the
      scan telescopes to the largest boundary <= i.

    Boundaries outside [0, n), such as those of trailing empty segments,
    are dropped (the JAX package's ``mode="drop"``): clamped in, they add 0.
    """
    b = offsets[1:-1]
    keep = ((b >= 0) & (b < n)).to(torch.int32)
    at = b.clamp(0, n - 1)
    dev = offsets.device
    ind = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(0, at, keep)
    seg = scan.scan_kernel(ind, inclusive=True)
    if not need_starts:
        return seg, None
    delta = (offsets[1:-1] - offsets[:-2]).to(torch.int32) * keep
    d = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(0, at, delta)
    return seg, scan.scan_kernel(d, inclusive=True)


def _sort_segments_core(keys, offsets, values, *, bit_count, descending, total_order,
                        values_are_ranks, make_ranks, method, tile):
    """Returns (keys, the values, or the uint32 ranks when `make_ranks`, or
    None), never aliasing the inputs."""
    n = keys.shape[0]
    S = offsets.shape[0] - 1
    have_values = values is not None or make_ranks
    if n <= 1:
        if make_ranks:
            return keys.clone(), torch.zeros(n, dtype=torch.uint32, device=keys.device)
        return keys.clone(), None if values is None else values.clone()

    full_cols, mk_cols, masked = common.order_cols(
        keys, bit_count, total_order=total_order, descending=descending)
    wide = common.is_64bit_key_dtype(keys.dtype)
    # the id packs above the masked key bits, never beside a 64-bit pair
    key_width = 32 if wide else bit_count
    seg, starts = segment_ids_and_starts(offsets, n, need_starts=make_ranks)
    seg_bits = max(1, (S - 1).bit_length())
    packed = not wide and seg_bits + key_width <= 32
    if packed:
        # in int64, so that an id reaching bit 31 wraps into the u32 pattern
        key_cols = ((seg.to(torch.int64) << key_width | mk_cols[0]).to(torch.int32),)
    else:
        key_cols = (seg, *mk_cols)

    carry_full = masked or descending
    stable = carry_full or have_values
    if make_ranks:
        vcols = (torch.arange(n, dtype=torch.int32, device=keys.device) - starts,)
    elif values is not None:
        vcols = common.values_to_u32_cols(values)
    else:
        vcols = ()

    if method == "xla":
        idx = _xla_order(key_cols)
        sorted_cols = [c[idx] for c in full_cols]
        v_sorted = [c[idx] for c in vcols]
    else:
        rank_tie = values_are_ranks and have_values
        payloads = list(full_cols) if carry_full else []
        if not rank_tie:
            payloads.extend(vcols)
        tie = vcols[0] if rank_tie else ("iota" if stable else None)
        buf = sort_mod._bitonic_pad_sort(key_cols, payloads, tie=tie, tile=tile)
        out = buf[:, :n]
        nk = len(key_cols)
        if carry_full:
            sorted_cols = out[nk + stable: nk + stable + len(full_cols)]
        elif packed:
            # an unmasked ascending 16-bit key under the id, nothing carried:
            # the key bits come back out of the packed word
            sorted_cols = (out[0] & common.i32(common.bit_mask(key_width)),)
        else:
            # unmasked ascending: the key columns follow the id's
            sorted_cols = out[1: 1 + len(full_cols)]
        v_sorted = (out[nk],) if rank_tie else out[out.shape[0] - len(vcols):]

        # no result may hold the padded network buffer alive
        sorted_cols = [common.own(c, buf) for c in sorted_cols]
        v_sorted = [common.own(c, buf) for c in v_sorted]

    out_keys = common.from_order_cols(sorted_cols, keys.dtype, total_order=total_order)
    if make_ranks:
        return out_keys, v_sorted[0].view(torch.uint32)
    if values is None:
        return out_keys, None
    return out_keys, common.values_from_u32_cols(v_sorted, values.dtype)


def _xla_order(key_cols) -> torch.Tensor:
    """The stable order of the key-column tuple through ``torch.sort``."""
    if len(key_cols) == 1:
        return torch.sort(common.bias_i32(key_cols[0]), stable=True)[1]
    if len(key_cols) == 2:
        return torch.sort(sort_mod._lex_word(*key_cols), stable=True)[1]
    seg, hi, lo = key_cols
    idx = torch.sort(sort_mod._lex_word(hi, lo), stable=True)[1]
    return idx[torch.sort(common.bias_i32(seg[idx]), stable=True)[1]]
