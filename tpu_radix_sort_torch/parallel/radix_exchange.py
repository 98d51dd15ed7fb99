"""Distributed sort through an exact-splitter radix exchange (one ragged
all-to-all).

Counterpart of ``tpu_radix_sort/parallel/radix_exchange.py``. After the
move into the padded layout (``parallel/layout.py``), each rank:

1. sorts its block of L = per elements by (key, idx) with the bitonic
   network (K1);
2. finds, for every global rank t = d*L (d = 1..D-1), how many of its
   elements rank below t (:func:`_select_splits`): a bisection of the key
   domain with 2^k probes a round, one ``psum`` of the probe counts a
   round, then the key ties at the boundary distributed in closed form
   from one ``all_gather`` of (keys below, keys equal), since idx order
   among equal keys is shard order;
3. sends its elements in [B_d, B_d+1) to rank d in one
   :func:`comm.all_to_all_v`; every rank receives exactly L elements, its
   chunks contiguous in source order;
4. merges the D sorted chunks: when every chunk fits its power-of-two slot
   (decided from the all-gathered D x D size matrix, so every rank takes
   the same branch) they go into their slots, the odd slots reversed, and
   ``bitonic.merge_tree_padded`` runs the log2(D) merge rounds that are
   left; otherwise the contiguous chunks are sorted again
   (``sort_padded_cols``), as when each rank's block goes whole to itself.

``torch.searchsorted`` has no uint32 kernel: u32 keys are searched as
int64 (nonnegative, so the order holds), 64-bit (hi, lo) keys as the
joined int64 XOR 2^63, with the probes computed as uint64 on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import bitonic, common
from . import comm
from .mesh_sort import _flat_sort

LANES = bitonic.LANES
_U32 = 0xFFFFFFFF


def _probe_log2(n_dev: int) -> int:
    """Probes a round of the key bisection, as a power of two: 2^16 while
    the (D - 1) * 2^k counts stay at 2^22 or fewer, else 2^8."""
    return 16 if (n_dev - 1) << 16 <= 1 << 22 else 8


def _search_keys(key_cols):
    """int64 whose signed order is the unsigned order of the key tuple:
    (u,) zero-extended, (hi, lo) joined and XORed with 2^63. Returns
    (keys, the XOR that maps a u64 pattern into their domain)."""
    if len(key_cols) == 1:
        return key_cols[0].to(torch.int64) & _U32, 0
    return common._join_u64(*key_cols) ^ common.SIGN_I64, common.SIGN_I64


def _as_search(patterns, flip, device) -> torch.Tensor:
    """Unsigned key patterns (a uint64 array) -> the search domain."""
    return torch.from_numpy(patterns.view(np.int64) ^ np.int64(flip)).to(device)


def _select_splits(key_cols, targets, group):
    """How many of this rank's sorted (key, idx) elements rank below each
    global rank in `targets` (a list of ints), as a list of ints; the sum
    over ranks equals each target, under any key skew.

    `key_cols`: the sorted key columns (1 or 2 int32 tensors of u32
    patterns) of this rank's block; the idx tie is implicit (the global
    iota, so idx order among equal keys is rank order).
    """
    sk, flip = _search_keys(key_cols)
    dev = sk.device
    key_bits = 32 * len(key_cols)
    k = _probe_log2(comm.axis_size(group))
    tg = torch.tensor(targets, dtype=torch.int64, device=dev)
    j = np.arange(1 << k, dtype=np.uint64)
    lo = np.zeros(len(targets), dtype=np.uint64)
    for r in range(key_bits // k):
        # the right edges of the 2^k sub-intervals, `step` wide, of the
        # interval [lo, lo + 2^(key_bits - r*k)) that holds each boundary key
        step = np.uint64(1 << (key_bits - (r + 1) * k))
        probes = lo[:, None] + j[None, :] * step + (step - np.uint64(1))
        c_local = torch.searchsorted(sk, _as_search(probes.reshape(-1), flip, dev),
                                     right=True)
        c = comm.psum(c_local, group).reshape(len(targets), 1 << k)
        # counts rise with the probe: the first edge above the target
        jstar = (c <= tg[:, None]).sum(1).cpu().numpy().astype(np.uint64)
        lo = lo + jstar * step
    K = _as_search(lo, flip, dev)  # the exact boundary keys
    a = torch.searchsorted(sk, K, right=False)  # keys below K
    m = torch.searchsorted(sk, K, right=True) - a  # keys equal to K
    am = comm.all_gather(torch.stack([a, m]), group).cpu()  # (D, 2, Q)
    me = comm.axis_index(group)
    t_ties = torch.tensor(targets, dtype=torch.int64) - am[:, 0].sum(0)
    ties_before = am[:me, 1].sum(0)
    take = torch.minimum(torch.clamp(t_ties - ties_before, min=0), am[me, 1])
    return (am[me, 0] + take).tolist()


def ragged_all_to_all(x, out_buf, starts, sizes, out_offsets, group):
    """``jax.lax.ragged_all_to_all`` over :func:`comm.all_to_all_v`, with the
    semantics that the JAX package's ``ragged_all_to_all_emulated`` pins:
    rank s sends columns ``x[:, starts[s][d] : starts[s][d] + sizes[s][d]]``
    to rank d, where they land at ``out_offsets[s][d]`` in d's `out_buf`;
    positions no chunk writes keep `out_buf`'s values. `starts`, `sizes` and
    `out_offsets` are the (D, D) nested lists of every rank's metadata, the
    same on every rank. x: (n_arr, L); returns this rank's out_buf."""
    n_dev, me = comm.axis_size(group), comm.axis_index(group)
    send = torch.cat([x[:, starts[me][d]:starts[me][d] + sizes[me][d]]
                      for d in range(n_dev)], dim=1)
    recv = comm.all_to_all_v(send.t().contiguous(), sizes, group).t()
    pos = 0
    for s in range(n_dev):
        sz = sizes[s][me]
        out_buf[:, out_offsets[s][me]:out_offsets[s][me] + sz] = recv[:, pos:pos + sz]
        pos += sz
    return out_buf


def _shard_exchange_sort(x, nk, group, *, tile=None):
    """The exchange sort of the blocks x ((n_arr, L) int32 a rank), by the
    leading `nk` columns: the key words, then the idx tie."""
    bitonic.sort_padded_cols(x, n_keys=nk, tile=tile)
    n_dev, me = comm.axis_size(group), comm.axis_index(group)
    if n_dev == 1:
        return x
    n_arr, L = x.shape
    s_mid = _select_splits(tuple(x[:nk - 1]), [L * d for d in range(1, n_dev)], group)
    starts = [0, *s_mid]
    send = [b - a for a, b in zip(starts, [*s_mid, L])]
    # sizes[s][d]: what rank s sends to rank d
    sizes = comm.all_gather(torch.tensor(send, dtype=torch.int64, device=x.device),
                            group).tolist()
    # D chunks in power-of-two slots: the state of a bitonic sort after
    # round k = slot, once the odd slots are reversed
    n_pow2 = 1 << (n_dev - 1).bit_length()
    slot = max(LANES, 2 * L // n_pow2)
    fits = max(max(row) for row in sizes) <= slot
    if fits:
        offsets = [[s * slot] * n_dev for s in range(n_dev)]
    else:
        offsets = [[sum(sizes[t][d] for t in range(s)) for d in range(n_dev)]
                   for s in range(n_dev)]
    # n_pow2 * slot >= 2L: room for the chunks either way
    buf = torch.full((n_arr, n_pow2 * slot), common.i32(common.SENTINEL_U32),
                     dtype=torch.int32, device=x.device)
    starts_all = [[sum(row[:d]) for d in range(n_dev)] for row in sizes]
    buf = ragged_all_to_all(x, buf, starts_all, sizes, offsets, group)
    if not fits:
        out = buf[:, :L].contiguous()
        return bitonic.sort_padded_cols(out, n_keys=nk, tile=tile)
    runs = buf.view(n_arr, n_pow2, slot)
    runs[:, 1::2] = runs[:, 1::2].flip(-1)
    bitonic.merge_tree_padded_cols(buf, run=slot, n_keys=nk, tile=tile)
    # the L real tuples sort before the all-sentinel fill
    return buf[:, :L].contiguous()


def exchange_sort(
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
    use_ragged_a2a=None,
    tile: int | None = None,
    device=None,
):
    """Stable sort of the global array across a mesh axis through one
    ragged exchange, exactly balanced under any key distribution; the
    axis size need not be a power of two.

    Same SPMD contract, semantics and options as ``mesh_sort`` (shards in,
    shards out, `count` and `bit_count` global). `use_ragged_a2a`,
    `block_rows` and `interpret` are accepted and ignored: the transport is
    ``all_to_all_single`` on every backend.
    """
    del block_rows, interpret, use_ragged_a2a
    return _flat_sort(
        keys, values, mesh=mesh, axis_name=axis_name, count=count, bit_count=bit_count,
        check_order=check_order, total_order=total_order, descending=descending,
        device=device,
        body=lambda x, nk, group: _shard_exchange_sort(x, nk, group, tile=tile))
