"""Distributed sort over a mesh axis: the bitonic compare-split network.

Counterpart of ``tpu_radix_sort/parallel/mesh_sort.py``:

1. the columns move into the JAX package's padded layout
   (``parallel/layout.py``), `per` elements a rank with the global iota as
   the tie;
2. each rank sorts its block by (key, idx) with the bitonic network (K1,
   ``ops/bitonic.py`` ``sort_padded_cols``);
3. a bitonic network over the D rank ids (D a power of two), where each
   compare-exchange is a compare-split: partners swap their whole blocks
   (:func:`comm.ppermute_start`), the received block is reversed, the lower side
   keeps the elementwise lexicographic minimum of each pair and the upper
   side the maximum (:func:`_compare_split_ce`), and each kept half, being
   bitonic, is sorted by one bitonic merge (``merge_padded_cols``,
   log2(per) stages);
4. the sorted real elements move back to the caller's shard lengths.

Every exchange moves the full fixed-size block, so key skew changes
nothing; (key, idx) tuples are distinct, so the sort is stable and its
output does not depend on the shards. ``overlap_chunks=S`` posts the S
chunk transfers of each exchange before the selects (async
``batch_isend_irecv``); the output is byte-identical to S = 1.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import bitonic, common
from ..utils import interop
from . import check, comm, layout


def _compare_split_ce(x, recv, keep_min: bool, nk: int) -> torch.Tensor:
    """Keep, pair by pair, the lexicographic minimum (`keep_min`) or maximum
    of the (n_arr, L) columns x and `recv` (the partner block, already
    reversed), comparing the leading `nk` columns (key words, then the
    unique tie), so the two sides keep complementary elements."""
    mine_lt = bitonic._lex_lt(x[:nk], recv[:nk])
    take_mine = mine_lt if keep_min else ~mine_lt
    return torch.where(take_mine, x, recv)


def _exchange_and_ce(x, perm, group, keep_min, overlap_chunks, nk):
    """One compare-split exchange, in S = `overlap_chunks` chunks whose
    transfers are all posted before the first select; my chunk c pairs
    with the partner's chunk S-1-c reversed (position p pairs with L-1-p)."""
    s = max(1, overlap_chunks)
    lc = x.shape[1] // s
    pending = [comm.ppermute_start(x[:, (s - 1 - c) * lc:(s - c) * lc], perm, group, tag=c)
               for c in range(s)]
    out = [_compare_split_ce(x[:, c * lc:(c + 1) * lc], pending[c].wait().flip(1),
                             keep_min, nk) for c in range(s)]
    return out[0] if s == 1 else torch.cat(out, dim=1)


def _compare_split_network(x, nk, group, *, overlap_chunks=1, tile=None):
    """Bitonic network over the rank ids with compare-split exchanges: the
    (n_arr, L) block x, sorted on each rank, comes back sorted in rank-major
    order across the axis."""
    n_dev, me = comm.axis_size(group), comm.axis_index(group)
    k = 2
    while k <= n_dev:
        j = k // 2
        while j >= 1:
            perm = [(i, i ^ j) for i in range(n_dev)]
            # ascending region when (me & k) == 0; the lower rank of a pair
            # keeps the minima
            keep_min = ((me & j) == 0) == ((me & k) == 0)
            half = _exchange_and_ce(x, perm, group, keep_min, overlap_chunks, nk)
            x = bitonic.merge_padded_cols(half, n_keys=nk, tile=tile)
            j //= 2
        k *= 2
    return x


def _shard_sort(x, nk, group, *, overlap_chunks=1, tile=None):
    """The compare-split sort of the blocks x (one (n_arr, per) int32 tensor
    a rank), by the leading `nk` columns."""
    bitonic.sort_padded_cols(x, n_keys=nk, tile=tile)
    if comm.axis_size(group) > 1:
        x = _compare_split_network(x, nk, group, overlap_chunks=overlap_chunks, tile=tile)
    return x


def sort_in_layout(key_cols, payloads, fills, *, group, lay, body, check_order=False):
    """Move this shard's real columns into the padded layout (`lay`), sort
    the blocks with ``body(x, n_keys)``, and move the real elements back.
    `key_cols` are the compare columns; the global iota follows them as the
    tie; `payloads` ride along, padded with `fills`. With `check_order`, a
    globally sorted key tuple skips `body`. Returns the sorted (key rows,
    payload rows) at this shard's real positions."""
    nk = len(key_cols)
    x = lay.block(key_cols, payloads, fills)
    if not (check_order and check.global_is_sorted(tuple(x[:nk]), group)):
        x = body(x, nk + 1)
    rows = torch.cat([x[:nk], x[nk + 1:]])[:, :lay.block_real]
    out = lay.back(rows)
    return out[:nk], out[nk:]


def _flat_sort(keys, values, *, mesh, axis_name, count, bit_count, check_order,
               total_order, descending, device, body, overlap_chunks=1):
    """Validation and key views of :func:`mesh_sort` and ``exchange_sort``
    around their `body` (``body(x, n_keys, group)``)."""
    group, n_dev, _ = common.mesh_axis(mesh, axis_name)
    keys = interop.as_tensor(keys, device)
    if keys.dim() != 1:
        raise ValueError("keys must be 1-D")
    common.check_key_dtype(keys.dtype)
    bit_count = common.native_key_bits(keys.dtype) if bit_count is None else bit_count
    common.validate_bit_count_for(keys.dtype, bit_count)
    if values is not None:
        values = interop.as_tensor(values, keys.device)
        if values.shape != keys.shape:
            raise ValueError("values must match keys shape")
        common.validate_value_dtype(values)
        values = values.contiguous()
    keys = keys.contiguous()
    lengths = layout.shard_lengths(keys.shape[0], group, keys.device)
    n = sum(lengths)
    if n >= common.MAX_LENGTH:
        raise ValueError(f"at most 2^31 - 1 keys, got {n}")
    count = n if count is None else int(count)
    if not 0 <= count <= n:
        raise ValueError(f"count {count} out of range for buffer of {n}")
    if count <= 1:
        return keys.clone() if values is None else (keys.clone(), values.clone())
    per = layout.padded_length(count, n_dev)
    if overlap_chunks > 1 and per % overlap_chunks:
        raise ValueError(f"overlap_chunks {overlap_chunks} must divide the padded "
                         f"per-shard length {per}")
    lay = layout.Layout(group, lengths, count, per)
    r = lay.local_real
    full, mk, masked = common.order_cols(keys[:r], bit_count, total_order=total_order,
                                         descending=descending)
    carry_full = masked or descending
    vcols = () if values is None else common.values_to_u32_cols(values[:r])
    payloads = (tuple(full) if carry_full else ()) + tuple(vcols)
    fills = [common.SENTINEL_U32] * (len(payloads) - len(vcols)) + [0] * len(vcols)
    s_keys, s_pay = sort_in_layout(
        mk, payloads, fills, group=group, lay=lay, check_order=check_order,
        body=lambda x, nk: body(x, nk, group))
    key_rows = s_pay[:len(full)] if carry_full else s_keys
    out_keys = common.from_order_cols(tuple(key_rows), keys.dtype, total_order=total_order)
    out_keys = torch.cat([out_keys, keys[r:]])
    if values is None:
        return out_keys
    v = common.values_from_u32_cols(tuple(s_pay[len(s_pay) - len(vcols):]), values.dtype)
    return out_keys, torch.cat([v, values[r:]])


def mesh_sort(
    keys,
    values=None,
    *,
    mesh,
    axis_name: str = "x",
    count=None,
    bit_count: int | None = None,
    check_order: bool = False,
    total_order: bool = False,
    descending: bool = False,
    block_rows=None,
    interpret=None,
    overlap_chunks: int = 1,
    tile: int | None = None,
    device=None,
):
    """Stable sort (ascending by default) of the global array whose shard
    this rank holds, across the `axis_name` dim of a ``DeviceMesh`` whose
    size is a power of two.

    SPMD: every rank of the axis calls it with its own shard of `keys` (and
    `values`), 1-D, of any length; `count` and `bit_count` are global. Each
    rank gets back its shard of the sorted global array, with the length of
    its input shard: the first `count` elements of the global array sorted,
    the rest untouched. Same key and value dtypes and options as ``sort``.
    ``check_order=True`` checks the global order first (one gather of the
    shards' edges, ``parallel/check.py``); a sorted input comes back
    unchanged. `tile` sets the bitonic network's tile; `block_rows` and
    `interpret` are accepted and ignored. Returns keys or (keys, values).
    """
    del block_rows, interpret
    _, n_dev, _ = common.mesh_axis(mesh, axis_name)
    if n_dev & (n_dev - 1):
        raise ValueError(f"mesh_sort needs a power-of-two axis size, got {n_dev}; "
                         f"exchange_sort takes any")
    return _flat_sort(
        keys, values, mesh=mesh, axis_name=axis_name, count=count, bit_count=bit_count,
        check_order=check_order, total_order=total_order, descending=descending,
        device=device, overlap_chunks=overlap_chunks,
        body=lambda x, nk, group: _shard_sort(x, nk, group, overlap_chunks=overlap_chunks,
                                              tile=tile))


def shard_length(n: int, n_dev: int, rank: int) -> int:
    """Length of shard `rank` of `n` elements split as ``torch.tensor_split``
    splits them: the first n % D shards one longer."""
    return n // n_dev + (rank < n % n_dev)


def sharded(mesh, axis_name: str, x, device=None):
    """This rank's shard of the global array `x` along its first dim:
    ``torch.tensor_split(x, D)[rank]``, contiguous. A tensor stays on its
    device unless `device` names another; numpy input goes to the CUDA
    card unless `device` says otherwise."""
    _, n_dev, me = common.mesh_axis(mesh, axis_name)
    if isinstance(x, torch.Tensor):
        return interop.as_tensor(torch.tensor_split(x, n_dev)[me], device).contiguous()
    return interop.as_tensor(np.array_split(np.asarray(x), n_dev)[me], device)
