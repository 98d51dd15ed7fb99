"""Top-level functional sort: feature assembly around the engines.

Counterpart of ``tpu_radix_sort/ops/sort.py`` for 32-bit keys, with the same
option surface: keys-only or key+value; sort only the first `count`
elements, the rest untouched; `bit_count` in 4..32 (order by the low bits
only, the full key carried along); uint32 keys, float32/int32 ordered by
their u32 bit pattern or by true total order with `total_order=True`;
stable ascending, or stable descending; `check_order` early exit.

Engines (`method`): 'bitonic' (the hand-written network, kernel K1; what
'auto' picks), 'xla' (``torch.sort(stable=True)`` on the sign-biased int32
view plus a gather of the payloads — the baseline, outside any kernel of
this package). 'radix' and `mesh=` come with later slices.

Device policy: a tensor runs where it lies; numpy or list input goes to the
CUDA card unless `device=` names another (see ``utils/interop.py``).
"""
from __future__ import annotations

import torch

from ..utils import interop
from . import bitonic, checksort, common

_METHODS = ("auto", "bitonic", "radix", "xla")

# The bitonic network needs a power-of-two length, so a plain pad can cost
# up to 2x. When the pad would waste >= 33% and the input is large enough
# to matter, sort the largest power-of-two prefix and the remainder
# separately and combine them with ONE bitonic merge. Module constant so
# tests can lower it to exercise the path at small sizes.
SPLIT_MIN_N = 1 << 21


def _bitonic_pad_sort(mkeys, *, stable, use_rank, ordered, tile):
    """Pad + sort through the bitonic engine, splitting non-pow2 inputs.

    Returns the padded sorted (n_cols, next_pow2(n)) int32 columns, layout
    [masked key, tie (if stable), payloads...]. A range whose pow2 pad would
    waste >= 33% is sorted as prefix + remainder (recursively) and combined
    with one merge; the result is byte-exact because real (key, tie) tuples
    are pairwise distinct and pads sort last.
    """
    dev = mkeys.device
    tail = ordered[1:] if use_rank else ordered
    n_cols = 1 + (1 if stable else 0) + len(tail)
    n_keys = 2 if stable else 1
    sentinel = common.i32(common.SENTINEL_U32)

    def build(lo, hi, pad_len):
        m = hi - lo
        x = torch.empty((n_cols, pad_len), dtype=torch.int32, device=dev)
        x[0, :m] = mkeys[lo:hi]
        x[0, m:] = sentinel
        r = 1
        if use_rank:
            # pad tie = pad key = SENTINEL_U32: real max-key elements
            # precede pads because their rank is < 0xFFFFFFFF (contract)
            x[1, :m] = ordered[0][lo:hi]
            x[1, m:] = sentinel
            r = 2
        elif stable:
            # global index tie-break, continued past the real data so pads
            # sort after every real element of this part
            x[1] = torch.arange(lo, lo + pad_len, dtype=torch.int32, device=dev)
            r = 2
        for p in tail:
            x[r, :m] = p[lo:hi]
            x[r, m:] = 0
            r += 1
        return x

    def sorted_cols(lo, hi):
        m = hi - lo
        m_pad = max(bitonic.LANES, common.next_pow2(m))
        a = m_pad // 2
        if not (m >= SPLIT_MIN_N and 3 * m_pad >= 4 * m and a >= bitonic.LANES):
            return bitonic.sort_padded_cols(build(lo, hi, m_pad), n_keys=n_keys,
                                            tile=tile)
        A = sorted_cols(lo, lo + a)  # exactly pow2: no pads inside
        B = sorted_cols(lo + a, hi)  # length next_pow2(m - a) <= a
        # extend B to length a with identical sentinel tuples (byte no-op
        # exchanges), reverse it so [A ascending ++ B descending] is a
        # bitonic sequence, and merge.
        ext = a - B.shape[1]
        if ext:
            fill = torch.zeros((n_cols, ext), dtype=torch.int32, device=dev)
            fill[:n_keys] = sentinel
            B = torch.cat([B, fill], dim=1)
        C = torch.cat([A, B.flip(1)], dim=1)
        del A, B
        return bitonic.merge_padded_cols(C, n_keys=n_keys, tile=tile)

    return sorted_cols(0, mkeys.shape[0])


def _resolve_method(method: str) -> str:
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method}")
    if method == "radix":
        raise NotImplementedError(
            "method='radix' is not ported yet: the radix engine comes with "
            "the 'ops/radix.py' slice of ROADMAP.md (Queue 1, item 8)"
        )
    return "bitonic" if method == "auto" else method


def _engine_sort(mkeys, payloads, *, stable, method, tile, rank_payload=None):
    """Sort by mkeys (stably if `stable`), co-permuting payloads.

    mkeys and payloads are 1-D int32 (u32 pattern) tensors. Returns
    (mkeys, payloads). `rank_payload`: index of a payload that is strictly
    increasing as u32 with every element < 0xFFFFFFFF (an argsort iota); it
    doubles as the stability tie-break, so the network carries one column
    fewer.
    """
    if method == "xla":
        sk, idx = torch.sort(common.bias_i32(mkeys), stable=True)
        return common.bias_i32(sk), tuple(p[idx] for p in payloads)

    n = mkeys.shape[0]
    use_rank = stable and rank_payload is not None
    if use_rank:
        # the rank payload moves to the tie-break slot (row 1)
        ordered = [payloads[rank_payload]] + [
            p for i, p in enumerate(payloads) if i != rank_payload
        ]
    else:
        ordered = list(payloads)
    out = _bitonic_pad_sort(mkeys, stable=stable, use_rank=use_rank,
                            ordered=ordered, tile=tile)
    k = out[0, :n]
    if use_rank:
        # ordered only moved the rank payload to the front; undo that
        tail = list(out[2:])
        tail.insert(rank_payload, out[1])
    else:
        tail = list(out[2:] if stable else out[1:])
    return k, tuple(p[:n] for p in tail)


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
    device=None,
    mesh=None,
    axis_name: str = "x",
):
    """Stable sort with the reference's semantics (ascending by default).

    Returns sorted keys, or (keys, values) when values is given, as new
    tensors on the keys' device. Elements at index >= count are returned
    untouched. Key dtypes: uint32/float32/int32; `values` any 4- or 8-byte
    dtype. `tile` overrides the bitonic engine's tile (elements per CUDA
    block, a power of two); the output does not depend on it.

    `values_are_ranks=True` promises that `values`, viewed as u32, is
    strictly increasing with every element < 0xFFFFFFFF (e.g. the identity
    iota of an argsort). The network then uses the payload itself as the
    stability tie-break; output is byte-identical. If the promise is broken,
    equal-key runs come out ordered by value bits instead of by position.
    """
    del axis_name
    common.reject_mesh(mesh)
    keys = interop.as_tensor(keys, device)
    if keys.dim() != 1:
        raise ValueError("keys must be 1-D")
    common.check_key_dtype(keys.dtype)
    bit_count = 32 if bit_count is None else bit_count
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
    method = _resolve_method(method)
    out_k, out_v = _sort_core(
        keys.contiguous(), None if values is None else values.contiguous(),
        common.bit_mask(bit_count), count=count, masked=bit_count < 32,
        check_order=check_order, total_order=total_order,
        descending=descending,
        values_are_ranks=values_are_ranks and values is not None,
        method=method, tile=tile,
    )
    return out_k if values is None else (out_k, out_v)


def _sort_core(keys, values, mask, *, count, masked, check_order, total_order,
               descending, values_are_ranks, method, tile):
    """Sort core. Always returns (keys, values_or_None), never aliasing the
    inputs."""
    n = keys.shape[0]
    if count <= 1:
        return keys.clone(), None if values is None else values.clone()

    head = keys[:count]
    u_full = (common.to_total_order_u32(head) if total_order
              else common.to_sortable_u32(head))
    mask = common.i32(mask)
    mkeys = u_full & mask if masked else u_full
    if descending:
        # stable descending == stable ascending on the flipped masked key
        mkeys = mkeys ^ mask

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
        mk, ps = _engine_sort(mkeys, tuple(payloads), stable=stable,
                              method=method, tile=tile,
                              rank_payload=rank_payload)
        ps = list(ps)
        if carry_full_key:
            u_sorted = ps.pop(0)
        else:
            u_sorted = mk ^ mask if descending else mk
        return (u_sorted, *ps[: len(vcols)])

    if check_order:
        result = checksort.with_early_exit(mkeys, (u_full, *vcols), do_sort)
    else:
        result = do_sort()

    u_sorted = result[0]
    if total_order:
        out_keys = common.from_total_order_u32(u_sorted, keys.dtype)
    else:
        out_keys = common.from_sortable_u32(u_sorted, keys.dtype)
    out_keys = torch.cat([out_keys, keys[count:]])
    if values is None:
        return out_keys, None
    out_values = common.values_from_u32_cols(result[1:], values.dtype)
    return out_keys, torch.cat([out_values, values[count:]])


def argsort(keys, *, device=None, **kwargs):
    """Indices (uint32) that stably sort keys. The iota payload satisfies
    the `values_are_ranks` contract, so argsort takes the 2-column path."""
    keys = interop.as_tensor(keys, device)
    idx = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
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
