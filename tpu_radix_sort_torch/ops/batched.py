"""Batched (per-row) sorts: independently sort each row of a 2-D tensor.

Counterpart of ``tpu_radix_sort/ops/batched.py``. The engine is the
row-local bitonic network (``ops/bitonic.py`` :func:`~.bitonic.row_schedule`,
kernel K1): rows pad to a power-of-two length with sentinels, the standard
rounds run up to half the row length (their runs never cross a row), and
one final round merges every row ascending. No row id is carried. Rows
shorter than the tile kernel's chunk share one; the row count is rounded up
with sentinel rows, cut off after the sort.

Stability per row, `descending`, `total_order`, masked `bit_count`, 4- and
8-byte values, `values_are_ranks` and every key dtype (16-, 32- and 64-bit)
carry over from the flat sort. `method='xla'` is one
``torch.sort(dim=1, stable=True)`` of each row's compare word (the biased
int32 view, or the int64 word of (hi, lo)) plus a gather of the rest.
`method='radix'` is refused, as in the JAX package.
"""
from __future__ import annotations

import functools

import torch

from ..utils import interop
from . import bitonic, common
from . import sort as sort_mod


def sort_batched(
    keys,
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
    """Sort each row of a (B, n) key tensor independently (stable, ascending
    by default), co-permuting an optional same-shape 4- or 8-byte `values`.

    Same key-dtype surface as :func:`~.sort.sort`; `bit_count` masks per key
    word like the flat sort. `values_are_ranks=True` promises each ROW of
    `values`, viewed as u32, is strictly increasing with every element
    < 0xFFFFFFFF (a per-row iota): the payload then doubles as the stability
    tie-break. Returns keys or (keys, values), same shape, on the keys'
    device. `tile` overrides the network's tile; `block_rows` and
    `interpret` (the JAX package's knobs) are accepted and ignored.

    `mesh=` (a ``DeviceMesh``) shards the batch dimension over the mesh dim
    `axis_name`: `keys` (and `values`) are this rank's block of rows, which
    it sorts on its own, with no collective (``parallel/batched.py``).
    """
    del block_rows, interpret
    keys = interop.as_tensor(keys, device)
    if keys.dim() != 2:
        raise ValueError("sort_batched expects a 2-D (batch, n) key array")
    if values is not None:
        values = interop.as_tensor(values, keys.device)
    bit_count, method = common.check_args(keys, values, bit_count=bit_count,
                                          values_are_ranks=values_are_ranks,
                                          method=method, name="sort_batched")
    core = _sort_batched_core
    if mesh is not None:
        from ..parallel.batched import mesh_sort_batched

        core = functools.partial(mesh_sort_batched, mesh=mesh, axis_name=axis_name)
    out_k, out_v = core(
        keys.contiguous(), None if values is None else values.contiguous(),
        bit_count=bit_count, descending=descending, total_order=total_order,
        values_are_ranks=values_are_ranks and values is not None, method=method,
        tile=tile,
    )
    return out_k if values is None else (out_k, out_v)


def argsort_batched(keys, *, device=None, **kwargs):
    """Per-row stable ranks (uint32): the positions each row's elements sort
    to. The per-row iota satisfies the rank contract, so this takes the
    rank-payload path, with no separate index column."""
    keys = interop.as_tensor(keys, device)
    if keys.dim() != 2:
        raise ValueError("argsort_batched expects a 2-D (batch, n) key array")
    ranks = torch.arange(keys.shape[1], dtype=torch.int32, device=keys.device)
    ranks = ranks.expand(keys.shape).view(torch.uint32)
    kwargs.setdefault("values_are_ranks", True)
    return sort_batched(keys, ranks, **kwargs)[1]


def _sort_batched_core(keys, values, *, bit_count, descending, total_order,
                       values_are_ranks, method, tile):
    """Always returns (keys, values_or_None), never aliasing the inputs."""
    B, n = keys.shape
    if B * n == 0 or n <= 1:
        return keys.clone(), None if values is None else values.clone()

    full_cols, mk_cols, masked = common.order_cols(
        keys.reshape(-1), bit_count, total_order=total_order, descending=descending)
    carry_full = masked or descending
    stable = carry_full or values is not None
    vcols = () if values is None else common.values_to_u32_cols(values.reshape(-1))

    if method == "xla":
        if len(mk_cols) == 1:
            word = common.bias_i32(mk_cols[0])
        else:
            word = sort_mod._lex_word(*mk_cols)
        _, idx = torch.sort(word.view(B, n), dim=1, stable=True)
        out = [torch.gather(c.view(B, n), 1, idx).reshape(-1) for c in (*full_cols, *vcols)]
        sorted_cols, v_sorted = out[:len(full_cols)], out[len(full_cols):]
    else:
        sorted_cols, v_sorted = _row_network(
            B, n, mk_cols, full_cols if carry_full else (), vcols, stable=stable,
            rank_tie=values_are_ranks, tile=tile)

    out_keys = common.from_order_cols(sorted_cols, keys.dtype,
                                      total_order=total_order).reshape(B, n)
    if values is None:
        return out_keys, None
    return out_keys, common.values_from_u32_cols(v_sorted, values.dtype).reshape(B, n)


def _row_network(B, n, mk_cols, full_cols, vcols, *, stable, rank_tie, tile):
    """Sort the (B, n) rows through the row-local network, by the compare
    columns `mk_cols` and a tie when `stable` (the rank payload, or a global
    iota: each element's position in its row, shifted), carrying
    `full_cols` and `vcols`. Returns the sorted, unpadded (key columns,
    value columns): the key columns are `full_cols` when carried, else the
    compare columns (an unmasked ascending key is its own full key)."""
    row_pad = max(bitonic.LANES, common.next_pow2(n))
    sentinel = common.i32(common.SENTINEL_U32)
    spec = [(c, sentinel) for c in mk_cols]
    if stable:
        spec.append((vcols[0], sentinel) if rank_tie else (None, None))
    spec += [(c, sentinel) for c in full_cols]
    if not rank_tie:
        spec += [(c, 0) for c in vcols]
    n_keys = len(mk_cols) + stable
    t, rows = bitonic.rows_layout(B, row_pad, len(spec), tile)
    dev = mk_cols[0].device
    x = torch.empty((len(spec), rows, row_pad), dtype=torch.int32, device=dev)
    for r, (c, fill) in enumerate(spec):
        if c is None:  # the iota tie
            torch.arange(rows * row_pad, dtype=torch.int32, device=dev, out=x[r].view(-1))
            continue
        x[r, :B, :n] = c.view(B, n)
        x[r, :B, n:] = fill
        x[r, B:] = fill
    bitonic.sort_rows_padded_cols(x.view(len(spec), -1), row_len=row_pad,
                                  n_keys=n_keys, tile=t)
    out = [x[r, :B, :n].reshape(-1) for r in range(len(spec))]
    key_out = out[n_keys:n_keys + len(full_cols)] if full_cols else out[:len(mk_cols)]
    v_out = (out[len(mk_cols)],) if rank_tie else out[len(spec) - len(vcols):]
    if len(key_out) + len(v_out) < len(spec):
        # views of x would hold its other columns alive
        key_out = [common.own(c, x) for c in key_out]
        v_out = [common.own(c, x) for c in v_out]
    return key_out, v_out
