"""Top-level functional sort: feature assembly around the engines.

Counterpart of ``tpu_radix_sort/ops/sort.py``, with the same option surface:
keys-only or key+value; sort only the first `count` elements, the rest
untouched; `bit_count` in 4..the key's width (order by the low bits only,
the full key carried along); uint32 keys, float32/int32 ordered by their u32
bit pattern or by true total order with `total_order=True`; 16-bit keys
(uint16/int16/float16/bfloat16) widened to their u16 pattern in a u32 lane;
64-bit keys (uint64/int64/float64) as (hi, lo) columns through
``ops/sort64.py``; stable ascending, or stable descending; `check_order`
early exit.

Engines (`method`): 'bitonic' (the hand-written network, kernel K1),
'radix' (the 4-way LSD radix sort, kernels K5, K4 and K6, ``ops/radix.py``),
'xla' (``torch.sort(stable=True)`` on the sign-biased int32 view plus a
gather of the payloads — the baseline, outside any kernel of this package).
'auto' takes the radix engine from `AUTO_RADIX_MIN_N` sorted keys of the
key's width on (3 * 2^21 for 32-bit keys), and the network below
(:func:`_resolve_method`). With `mesh=`, a ``DeviceMesh``, the call is one
rank's part of a distributed sort (``parallel/``): `method` picks the
strategy, 'mesh' (the compare-split network), 'exchange' (the radix
exchange) or 'auto' (:func:`_resolve_mesh_method`).

Device policy: a tensor runs where it lies; numpy or list input goes to the
CUDA card unless `device=` names another (see ``utils/interop.py``).
"""
from __future__ import annotations

import torch

from ..runtime.profiler import annotate
from ..utils import interop
from . import bitonic, checksort, common, radix

_METHODS = ("auto", "bitonic", "radix", "xla")
_MESH_METHODS = ("auto", "mesh", "exchange")

# The bitonic network needs a power-of-two length, so a plain pad can cost
# up to 2x. When the pad would waste >= 33% and the input is large enough
# to matter, sort the largest power-of-two prefix and the remainder
# separately and combine them with ONE bitonic merge. Module constant so
# tests can lower it to exercise the path at small sizes.
SPLIT_MIN_N = 1 << 21

# 'auto' takes the radix engine when the sorted count is at least this, by
# the key dtype's width in bits, and the bitonic network below: the least
# size from which radix won at every larger size of the H100 sweep
# (``benchmarks/engines.py``, PERF.md), with every payload, with and without
# `check_order`, back to back and, below 2^18, one synchronous call at a time.
# A module constant so tests can move it.
AUTO_RADIX_MIN_N = {16: 262_144, 32: 6_291_456, 64: 6_291_456}


def _bitonic_pad_sort(key_cols, payloads, *, tie, tile):
    """Pad + sort through the bitonic engine, splitting non-pow2 inputs.

    `key_cols` are 1-D int32 (u32 pattern) columns compared
    lexicographically: (mkeys,) for 16- and 32-bit keys, (hi, lo) or (lo,)
    for 64-bit keys. `tie` is None (not stable), ``"iota"`` (the global
    index as tie-break) or a rank column (the `values_are_ranks` contract).
    Returns the padded sorted (n_cols, next_pow2(n)) int32 columns, layout
    [key columns, tie (if any), payloads...]. A range whose pow2 pad would
    waste >= 33% is sorted as prefix + remainder (recursively) and combined
    with one merge; the result is byte-exact because real (keys, tie)
    tuples are pairwise distinct and pads sort last. Nothing of the call
    outlives it: the recursion is module-level and captures nothing.
    """
    rank = tie if isinstance(tie, torch.Tensor) else None
    # pad tie = pad key = SENTINEL_U32: real max-key elements precede pads
    # because their rank is < 0xFFFFFFFF (contract)
    padded = tuple(key_cols) + (() if rank is None else (rank,))
    return _sorted_part(padded, tie is not None and rank is None, tuple(payloads),
                        len(key_cols) + (tie is not None), 0, key_cols[0].shape[0], tile)


def _padded_part(padded, iota, payloads, n_keys, lo, hi, pad_len):
    """Elements lo:hi of the `padded` key (and rank) columns, the iota tie
    where `iota`, and the payloads, as one (n_keys + len(payloads), pad_len)
    int32 tensor: keys and tie padded with the sentinel, payloads with 0."""
    m = hi - lo
    dev = padded[0].device
    sentinel = common.i32(common.SENTINEL_U32)
    x = torch.empty((n_keys + len(payloads), pad_len), dtype=torch.int32, device=dev)
    for r, c in enumerate(padded):
        x[r, :m] = c[lo:hi]
        x[r, m:] = sentinel
    if iota:
        # global index tie-break, continued past the real data so pads
        # sort after every real element of this part
        x[n_keys - 1] = torch.arange(lo, lo + pad_len, dtype=torch.int32, device=dev)
    for r, c in enumerate(payloads, n_keys):
        x[r, :m] = c[lo:hi]
        x[r, m:] = 0
    return x


def _sorted_part(padded, iota, payloads, n_keys, lo, hi, tile):
    """The sorted :func:`_padded_part` of elements lo:hi, split and merged
    where its pad would waste >= 33%."""
    m = hi - lo
    m_pad = max(bitonic.LANES, common.next_pow2(m))
    a = m_pad // 2
    if not (m >= SPLIT_MIN_N and 3 * m_pad >= 4 * m and a >= bitonic.LANES):
        x = _padded_part(padded, iota, payloads, n_keys, lo, hi, m_pad)
        return bitonic.sort_padded_cols(x, n_keys=n_keys, tile=tile)
    # A exactly pow2 (no pads inside); B of length next_pow2(m - a) <= a
    A = _sorted_part(padded, iota, payloads, n_keys, lo, lo + a, tile)
    B = _sorted_part(padded, iota, payloads, n_keys, lo + a, hi, tile)
    # extend B to length a with identical sentinel tuples (byte no-op
    # exchanges), reverse it so [A ascending ++ B descending] is a
    # bitonic sequence, and merge.
    ext = a - B.shape[1]
    if ext:
        fill = torch.zeros((B.shape[0], ext), dtype=torch.int32, device=B.device)
        fill[:n_keys] = common.i32(common.SENTINEL_U32)
        B = torch.cat([B, fill], dim=1)
    C = torch.cat([A, B.flip(1)], dim=1)
    del A, B
    return bitonic.merge_padded_cols(C, n_keys=n_keys, tile=tile)


def _bitonic_engine(key_cols, payloads, *, stable, rank_payload, tile):
    """Sort by the lexicographic key-column tuple through the bitonic
    network, stably if `stable`, co-permuting payloads. Returns (key_cols,
    payloads), each trimmed to the input length.

    `rank_payload`: index of a payload that is strictly increasing as u32
    with every element < 0xFFFFFFFF (an argsort iota); it doubles as the
    stability tie-break, so the network carries one column fewer.
    """
    n = key_cols[0].shape[0]
    nk = len(key_cols)
    if stable and rank_payload is not None:
        rest = [p for i, p in enumerate(payloads) if i != rank_payload]
        out = _bitonic_pad_sort(key_cols, rest, tie=payloads[rank_payload], tile=tile)
        # the rank payload rode in the tie slot; put it back in its place
        tail = list(out[nk + 1:, :n])
        tail.insert(rank_payload, out[nk, :n])
    else:
        out = _bitonic_pad_sort(key_cols, payloads, tie="iota" if stable else None,
                                tile=tile)
        tail = list(out[nk + stable:, :n])
    return tuple(out[:nk, :n]), tuple(tail)


def _takes_tile(method: str, tile) -> bool:
    """Whether the engine accepts an explicit `tile` (None: its own)."""
    if tile is None:
        return True
    lo, hi = (radix.MIN_TILE, radix.MAX_TILE) if method == "radix" else (2, bitonic.MAX_TILE)
    return lo <= tile <= hi and not tile & (tile - 1)


def _resolve_method(method: str, *, count: int = 0, key_bits: int = 32, tile=None) -> str:
    """The engine of a sort of `count` keys of a `key_bits`-wide dtype.
    'auto' takes 'radix' from ``AUTO_RADIX_MIN_N[key_bits]`` keys on and
    'bitonic' below, unless an explicit `tile` suits only the other.

    `key_bits` is the dtype's width, not the key words the engines sort: a
    64-bit key with `bit_count` <= 32 runs one key column, as a 32-bit key
    does, but reads the 64-bit entry (equal to the 32-bit one as measured)."""
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method}")
    if method != "auto":
        return method
    pick, other = (("radix", "bitonic") if count >= AUTO_RADIX_MIN_N[key_bits]
                   else ("bitonic", "radix"))
    return other if not _takes_tile(pick, tile) and _takes_tile(other, tile) else pick


def _resolve_mesh_method(method: str, n_dev: int) -> str:
    """The distributed strategy for an axis of `n_dev` ranks. 'auto' takes
    the compare-split network ('mesh') at 4 ranks or fewer, as the JAX
    package does, and the exchange above; the network needs a power of
    two, so 'auto' also takes the exchange at 3 ranks, where the JAX
    package's network fails."""
    if method not in _MESH_METHODS:
        raise ValueError(f"with mesh=, method must be one of {_MESH_METHODS}, got {method}")
    if method == "auto":
        return "mesh" if n_dev <= 4 and not n_dev & (n_dev - 1) else "exchange"
    return method


def _lex_word(hi, lo) -> torch.Tensor:
    """int64 whose signed order is the unsigned order of the pair (hi, lo)."""
    return common._join_u64(hi, lo) ^ common.SIGN_I64


def _engine_sort(key_cols, payloads, *, stable, method, tile, key_bits=32,
                 rank_payload=None, check_order=False):
    """Sort by the lexicographic key-column tuple (stably if `stable`),
    co-permuting payloads.

    key_cols and payloads are 1-D int32 (u32 pattern) tensors; key_cols is
    (mkeys,) for 16- and 32-bit keys, (hi, lo) or (lo,) for 64-bit keys.
    Returns (key_cols, payloads). `key_bits`: the number of meaningful low
    bits of the tuple (the radix engine's passes: ``radix.digit_widths``).
    `rank_payload`: see :func:`_bitonic_engine`. The radix engine is stable
    by construction and ignores it; it alone takes `check_order`, its
    mid-sort early exit, on one key column.
    """
    if method == "radix":
        if len(key_cols) == 1:
            k, ps = radix.sort_u32(key_cols[0], payloads, bit_count=key_bits, tile=tile,
                                   check_order=check_order)
            return (k,), ps
        # LSD composition over the 32-bit words: each sort_u32 is stable, so
        # sorting by lo then by hi orders by (hi, lo); hi holds the masked
        # bits above 32 (two columns only when key_bits > 32). A span a
        # word, so that a trace tells the engine's time from the 64-bit
        # layer's own (``ops/sort64.py``)
        hi, lo = key_cols
        with annotate("radix.lo_word"):
            lo, carried = radix.sort_u32(lo, (hi, *payloads), bit_count=32, tile=tile)
        with annotate("radix.hi_word"):
            hi, carried = radix.sort_u32(carried[0], (lo, *carried[1:]),
                                         bit_count=key_bits - 32, tile=tile)
        return (hi, carried[0]), carried[1:]
    if method == "xla":
        if len(key_cols) == 1:
            sk, idx = torch.sort(common.bias_i32(key_cols[0]), stable=True)
            return (common.bias_i32(sk),), tuple(p[idx] for p in payloads)
        _, idx = torch.sort(_lex_word(*key_cols), stable=True)
        return tuple(c[idx] for c in key_cols), tuple(p[idx] for p in payloads)

    return _bitonic_engine(key_cols, payloads, stable=stable,
                           rank_payload=rank_payload, tile=tile)


def sort(
    keys,
    values=None,
    *,
    count=None,
    bit_count: int | None = None,
    check_order: bool = False,
    total_order: bool = False,
    descending: bool = False,
    values_are_ranks: bool = False,
    method: str = "auto",
    tile: int | None = None,
    block_rows=None,
    interpret=None,
    device=None,
    mesh=None,
    axis_name: str = "x",
):
    """Stable sort with the reference's semantics (ascending by default).

    Returns sorted keys, or (keys, values) when values is given, as new
    tensors on the keys' device. Elements at index >= count are returned
    untouched. Key dtypes: uint32/float32/int32; uint16/int16/float16/
    bfloat16 (their u16 bit pattern, `bit_count` up to 16); uint64/int64/
    float64 (``ops/sort64.py``, `bit_count` up to 64). `bit_count` defaults
    to the key's width. `values` any 4- or 8-byte dtype. `tile` overrides
    the engine's tile (elements per CUDA block, a power of two); the output
    does not depend on it.

    `values_are_ranks=True` promises that `values`, viewed as u32, is
    strictly increasing with every element < 0xFFFFFFFF (e.g. the identity
    iota of an argsort). The network then uses the payload itself as the
    stability tie-break; output is byte-identical. If the promise is broken,
    equal-key runs come out ordered by value bits instead of by position on
    the bitonic route; the radix engine, stable by construction, ignores the
    promise and keeps input order.

    `block_rows` and `interpret`, the JAX package's tiling and Pallas knobs,
    are accepted and ignored: the output does not depend on the tile.

    `mesh=` (a ``torch.distributed.device_mesh.DeviceMesh``) makes the call
    this rank's part of a distributed sort over the mesh dim `axis_name`:
    `keys` and `values` are this rank's shards of the global arrays, `count`
    and `bit_count` are global, and the result is this rank's shard of the
    sorted global array (``parallel/mesh_sort.py``). `method` is then
    'auto', 'mesh' or 'exchange' (:func:`_resolve_mesh_method`);
    `values_are_ranks` is ignored, the global index being the tie.
    """
    del block_rows, interpret
    if mesh is not None:
        from .. import parallel  # local import: parallel builds on ops

        _, n_dev, _ = common.mesh_axis(mesh, axis_name)
        fn = (parallel.mesh_sort if _resolve_mesh_method(method, n_dev) == "mesh"
              else parallel.exchange_sort)
        return fn(keys, values, mesh=mesh, axis_name=axis_name, count=count,
                  bit_count=bit_count, check_order=check_order, total_order=total_order,
                  descending=descending, tile=tile, device=device)
    keys = interop.as_tensor(keys, device)
    if keys.dim() != 1:
        raise ValueError("keys must be 1-D")
    common.check_key_dtype(keys.dtype)
    bit_count = common.native_key_bits(keys.dtype) if bit_count is None else bit_count
    common.validate_bit_count_for(keys.dtype, bit_count)
    n = keys.shape[0]
    if n >= bitonic.MAX_LENGTH:
        raise ValueError(f"at most 2^31 - 1 keys, got {n}")
    count = n if count is None else int(count)
    if not 0 <= count <= n:
        raise ValueError(f"count {count} out of range for buffer of {n}")
    if values is not None:
        values = interop.as_tensor(values, keys.device)
        if values.dim() != 1 or values.shape[0] != n:
            raise ValueError("values must be 1-D with the same length as keys")
        common.validate_value_dtype(values)
        if values_are_ranks and values.dtype.itemsize != 4:
            raise ValueError(
                "values_are_ranks requires a 32-bit value dtype (the rank "
                "contract is a single u32 column)"
            )
    method = _resolve_method(method, count=count, key_bits=common.native_key_bits(keys.dtype),
                             tile=tile)
    core = _sort_core
    if common.is_64bit_key_dtype(keys.dtype):
        from . import sort64  # local import: sort64 builds on this module

        core = sort64.sort64
    out_k, out_v = core(
        keys.contiguous(), None if values is None else values.contiguous(),
        count=count, bit_count=bit_count, check_order=check_order,
        total_order=total_order, descending=descending,
        values_are_ranks=values_are_ranks and values is not None,
        method=method, tile=tile,
    )
    return out_k if values is None else (out_k, out_v)


def _sort_core(keys, values, *, count, bit_count, check_order, total_order,
               descending, values_are_ranks, method, tile):
    """Sort core of 16- and 32-bit keys. Always returns (keys,
    values_or_None), never aliasing the inputs."""
    if count <= 1:
        return keys.clone(), None if values is None else values.clone()

    (u_full,), (mkeys,), masked = common.order_cols(
        keys[:count], bit_count, total_order=total_order, descending=descending)

    carry_full_key = masked
    stable = carry_full_key or values is not None
    payloads = [u_full] if carry_full_key else []
    rank_payload = None
    vcols = ()
    if values is not None:
        vcols = common.values_to_u32_cols(values[:count])
        if values_are_ranks:
            rank_payload = len(payloads)
        payloads.extend(vcols)

    def do_sort():
        (mk,), ps = _engine_sort((mkeys,), tuple(payloads), stable=stable,
                                  method=method, tile=tile, key_bits=bit_count,
                                  rank_payload=rank_payload, check_order=check_order)
        ps = list(ps)
        if carry_full_key:
            u_sorted = ps.pop(0)
        else:
            # unmasked: the compare key is the full key, its low
            # bit_count bits flipped when descending
            u_sorted = mk ^ common.i32(common.bit_mask(bit_count)) if descending else mk
        return (u_sorted, *ps[: len(vcols)])

    if check_order and method != "radix":
        # the radix engine checks mid-sort instead (_engine_sort)
        result = checksort.with_early_exit(mkeys, (u_full, *vcols), do_sort)
    else:
        result = do_sort()

    out_keys = common.from_order_cols(result[:1], keys.dtype, total_order=total_order)
    return with_suffix(keys, values, count, out_keys, result[1:])


def with_suffix(keys, values, count, out_keys, vcols):
    """The sorted head (`out_keys`, and the value columns `vcols`) joined
    with the untouched elements from `count` on, as (keys, values_or_None)."""
    out_keys = torch.cat([out_keys, keys[count:]])
    if values is None:
        return out_keys, None
    out_values = common.values_from_u32_cols(vcols, values.dtype)
    return out_keys, torch.cat([out_values, values[count:]])


def argsort(keys, *, device=None, **kwargs):
    """Indices (uint32) that stably sort keys. The iota payload satisfies
    the `values_are_ranks` contract, so argsort takes the 2-column path.
    With `mesh=`, `keys` is this rank's shard, and the indices are global
    positions: this rank's shard of the global argsort."""
    keys = interop.as_tensor(keys, device)
    start = 0
    if kwargs.get("mesh") is not None:
        from ..parallel import layout

        group, _, me = common.mesh_axis(kwargs["mesh"], kwargs.get("axis_name", "x"))
        start = sum(layout.shard_lengths(keys.shape[0], group, keys.device)[:me])
    idx = torch.arange(start, start + keys.shape[0], dtype=torch.int32, device=keys.device)
    kwargs.setdefault("values_are_ranks", True)
    _, out = sort(keys, idx.view(torch.uint32), **kwargs)
    return out


def sort_packed(packed, *, count=None, device=None, **kwargs):
    """Sort packed (key, value) records: tensor [..., 2] u32, key in [..., 0],
    rows linearized row-major like the reference's texture addressing."""
    packed = interop.as_tensor(packed, device)
    if packed.shape[-1] != 2:
        raise ValueError("packed records must have trailing dimension 2")
    lead_shape = packed.shape[:-1]
    flat = packed.reshape(-1, 2)
    k, v = sort(flat[:, 0].contiguous(), flat[:, 1].contiguous(), count=count,
                **kwargs)
    return torch.stack([k, v], dim=-1).reshape(*lead_shape, 2)
