"""Golden model: the reference's sort semantics, in NumPy (32-bit keys).

The port's own copy of the 32-bit part of ``tpu_radix_sort/models/golden.py``
(the port imports nothing of the JAX package). It is the byte-exact oracle
the port is held to, on the CPU and in ``chip_smoke.py``:

- stable ascending sort of the first ``count`` elements, the rest untouched;
- ordering key is the low ``bit_count`` bits of the u32 bit pattern
  (float32/int32 reinterpret their bits, the reference's contract), or of
  the total-order bijection with ``total_order=True``;
- ``descending`` is a stable ascending sort of the bit-flipped masked key;
- the optional value payload is permuted identically to the keys;
- the prefix sum is exclusive, with u32 wraparound, over the first
  ``count`` elements, the rest untouched.
"""
from __future__ import annotations

import numpy as np

__all__ = ["golden_sort", "golden_is_sorted", "golden_prefix_sum"]


def _bit_pattern_u32(keys: np.ndarray) -> np.ndarray:
    if keys.dtype == np.uint32:
        return keys
    if keys.dtype in (np.float32, np.int32):
        return keys.view(np.uint32)
    raise TypeError(
        f"unsupported key dtype {keys.dtype}; expected uint32/float32/int32"
    )


def _total_order_u32(keys: np.ndarray) -> np.ndarray:
    if keys.dtype == np.uint32:
        return keys
    if keys.dtype == np.int32:
        return keys.view(np.uint32) ^ np.uint32(0x80000000)
    if keys.dtype == np.float32:
        u = keys.view(np.uint32)
        flip = np.where((u >> np.uint32(31)) == 1,
                        np.uint32(0xFFFFFFFF), np.uint32(0x80000000))
        return u ^ flip
    raise TypeError(f"unsupported key dtype {keys.dtype}")


def _key_view(keys, n, bit_count, total_order, descending):
    if not (4 <= bit_count <= 32) or bit_count % 4 != 0:
        raise ValueError("bit_count must be a multiple of 4 in [4, 32]")
    u = (_total_order_u32(keys) if total_order else _bit_pattern_u32(keys))[:n]
    mask = np.uint32((1 << bit_count) - 1)
    mk = u & mask
    return mk ^ mask if descending else mk


def golden_sort(
    keys: np.ndarray,
    values: np.ndarray | None = None,
    *,
    count: int | None = None,
    bit_count: int | None = None,
    total_order: bool = False,
    descending: bool = False,
):
    """Reference-semantics sort. Returns (keys, values) or keys if values is None."""
    keys = np.asarray(keys)
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    n = keys.shape[0] if count is None else int(count)
    if not (0 <= n <= keys.shape[0]):
        raise ValueError(f"count {n} out of range for buffer of {keys.shape[0]}")
    bit_count = 32 if bit_count is None else bit_count
    mk = _key_view(keys, n, bit_count, total_order, descending)
    order = np.argsort(mk, kind="stable")
    out_keys = keys.copy()
    out_keys[:n] = keys[:n][order]
    if values is None:
        return out_keys
    values = np.asarray(values)
    if values.shape[0] < n:
        raise ValueError("values buffer shorter than count")
    out_values = values.copy()
    out_values[:n] = values[:n][order]
    return out_keys, out_values


def golden_is_sorted(keys: np.ndarray, *, count: int | None = None,
                     bit_count: int | None = None, total_order: bool = False,
                     descending: bool = False) -> bool:
    """Adjacent-pair order check over the sorted-by key view (bijection,
    mask, then flip — exactly the sort's key pipeline)."""
    keys = np.asarray(keys)
    n = keys.shape[0] if count is None else int(count)
    bit_count = 32 if bit_count is None else bit_count
    u = _key_view(keys, n, bit_count, total_order, descending)
    return bool(np.all(u[:-1] <= u[1:])) if n > 1 else True


def golden_prefix_sum(items: np.ndarray, *, count: int | None = None) -> np.ndarray:
    """Exclusive prefix sum of the first `count` elements, u32 wraparound,
    in the items' dtype (uint32 or int32, same bits); the rest untouched.

    Exact in uint64 throughout (the JAX package's copy concatenates a
    Python ``[0]``, which promotes to float64 and rounds sums above 2^53).
    """
    items = np.asarray(items)
    n = items.shape[0] if count is None else int(count)
    out = items.copy()
    seg = items[:n].view(np.uint32).astype(np.uint64)
    out[:n] = (np.cumsum(seg) - seg).astype(np.uint32).view(items.dtype)
    return out
