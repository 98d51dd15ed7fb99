"""64-bit key sorts: uint64 / int64 / float64.

Counterpart of ``tpu_radix_sort/ops/sort64.py``: the option surface of the
32-bit sort (sub-`count`, `bit_count` here 4..64, `check_order`,
`descending`, `total_order`, values, `values_are_ranks`) on 64-bit keys,
through the same engines. A key is two u32 columns (hi, lo), whose
lexicographic order is the u64 order; with `bit_count` <= 32 the masked hi
column is all-zero and only (lo,) goes in.

The engines are those of the 32-bit sort (``ops/sort._engine_sort``),
given the key-column tuple; 'auto' takes bitonic below
``AUTO_RADIX_MIN_N[64]`` keys and radix from there:

- **bitonic**: (hi, lo) lead the network's compare
  tuple, with the tie column after them: `n_keys` 3 for a stable sort, 2
  keys-only. The widest case, `bit_count`
  in 36..60 with 8-byte values that are not ranks, carries 7 columns
  (hi, lo, tie, the full key's hi and lo, the value's hi and lo).
- **radix**: LSD composition over the two words: the stable 32-bit radix
  sort on lo, carrying hi and the payloads, then on hi, carrying lo
  (``ops/radix.sort_u32`` twice), 4 passes on lo and
  ``radix.digit_widths(bit_count - 32)`` on the masked hi (2 at 44 bits).
- **xla**: ``torch.sort(stable=True)`` on the int64 word
  ``((hi << 32) | lo) ^ INT64_MIN`` plus a gather — the baseline.

`check_order` gates the whole pipeline for every engine, the radix engine
included, on the two-column order check (K3, ``ops/checksort.py``); the
32-bit path's radix engine checks mid-sort instead, and the port keeps that
difference of the JAX package.
"""
from __future__ import annotations

from ..runtime.profiler import annotate
from . import checksort, common
from . import sort as sort_mod


@annotate("sort64")
def sort64(keys, values, *, count, bit_count, check_order, total_order,
           descending, values_are_ranks, method, tile):
    """Sort core of 64-bit keys (called from :func:`ops.sort.sort` with
    validated arguments). Always returns (keys, values_or_None), never
    aliasing the inputs. Each call is the span ``sort64``; the radix
    engine's two word sorts within it are ``radix.lo_word`` and
    ``radix.hi_word`` (``ops/sort._engine_sort``)."""
    if count <= 1:
        return keys.clone(), None if values is None else values.clone()

    # bit_count <= 32: the masked hi column is all-zero and order_cols
    # leaves it out of the compare tuple (same order, one column fewer)
    (u_hi, u_lo), key_cols, carry_full_key = common.order_cols(
        keys[:count], bit_count, total_order=total_order, descending=descending)

    stable = carry_full_key or values is not None
    payloads = [u_hi, u_lo] if carry_full_key else []
    rank_payload = None
    vcols = ()
    if values is not None:
        vcols = common.values_to_u32_cols(values[:count])
        if values_are_ranks:
            rank_payload = len(payloads)  # 4-byte only (validated upstream)
        payloads.extend(vcols)

    def do_sort():
        kc, ps = sort_mod._engine_sort(key_cols, tuple(payloads), stable=stable,
                                       rank_payload=rank_payload, method=method,
                                       tile=tile, key_bits=bit_count)
        ps = list(ps)
        if carry_full_key:
            s_hi, s_lo = ps.pop(0), ps.pop(0)
        else:
            # not masked => bit_count == 64 => both columns in the tuple,
            # and the descending flip is a complement
            s_hi, s_lo = kc
            if descending:
                s_hi, s_lo = ~s_hi, ~s_lo
        return (s_hi, s_lo, *ps[: len(vcols)])

    if check_order and checksort.is_sorted_cols(key_cols):
        result = (u_hi, u_lo, *vcols)
    else:
        result = do_sort()

    out_keys = common.from_order_cols(result[:2], keys.dtype, total_order=total_order)
    return sort_mod.with_suffix(keys, values, count, out_keys, result[2:])

