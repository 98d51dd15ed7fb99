"""Golden model: the reference's sort semantics, in NumPy.

The port's own copy of ``tpu_radix_sort/models/golden.py`` (the port imports
nothing of the JAX package). It is the byte-exact oracle the port is held
to, on the CPU and in ``chip_smoke.py``:

- stable ascending sort of the first ``count`` elements, the rest untouched;
- ordering key is the low ``bit_count`` bits of the key's bit pattern:
  u32 for 32-bit keys (float32/int32 reinterpret their bits, the
  reference's contract), the u16 pattern for 16-bit keys, u64 for 64-bit
  keys; or of the total-order bijection with ``total_order=True``;
  ``bit_count`` defaults to the key's width;
- ``descending`` is a stable ascending sort of the bit-flipped masked key;
- the optional value payload is permuted identically to the keys;
- the prefix sum is exclusive, with u32 wraparound, over the first
  ``count`` elements, the rest untouched.

NumPy has no bfloat16. bfloat16 keys come in as their uint16 bit patterns
with ``bf16_bits=True``, which only changes the total order (a float's
sign-flip rule instead of the unsigned one); the returned keys are then
uint16 patterns too.
"""
from __future__ import annotations

import numpy as np

__all__ = ["golden_sort", "golden_is_sorted", "golden_prefix_sum"]


def _width(keys: np.ndarray) -> int:
    dt = keys.dtype
    if dt in (np.uint64, np.int64, np.float64):
        return 64
    if dt in (np.uint32, np.int32, np.float32):
        return 32
    if dt in (np.uint16, np.int16, np.float16):
        return 16
    raise TypeError(f"unsupported key dtype {dt}")


def _pattern(keys: np.ndarray, width: int) -> np.ndarray:
    """The unsigned bit pattern the sort orders by (16-bit keys widened to
    u32, as the sort's lane holds them)."""
    if width == 16:
        return keys.view(np.uint16).astype(np.uint32)
    return keys.view(np.uint64 if width == 64 else np.uint32)


def _total_order(keys: np.ndarray, width: int, bf16_bits: bool) -> np.ndarray:
    """The monotone bijection of ``ops/common.to_total_order_*``: signed
    integers offset by the sign bit, floats by the sign-flip trick."""
    u = _pattern(keys, width)
    ut = u.dtype.type
    sign = ut(1 << (width - 1))
    ones = ut((1 << width) - 1)
    kind = "f" if bf16_bits else keys.dtype.kind
    if kind == "u":
        return u
    if kind == "i":
        return u ^ sign
    return u ^ np.where((u & sign) != 0, ones, sign).astype(u.dtype)


def _key_view(keys, n, bit_count, total_order, descending, bf16_bits):
    width = _width(keys)
    bit_count = width if bit_count is None else bit_count
    if not (4 <= bit_count <= width) or bit_count % 4 != 0:
        raise ValueError(f"bit_count must be a multiple of 4 in [4, {width}]")
    u = (_total_order(keys, width, bf16_bits) if total_order
         else _pattern(keys, width))[:n]
    mask = u.dtype.type((1 << bit_count) - 1)
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
    bf16_bits: bool = False,
):
    """Reference-semantics sort. Returns (keys, values) or keys if values is None."""
    keys = np.asarray(keys)
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    n = keys.shape[0] if count is None else int(count)
    if not (0 <= n <= keys.shape[0]):
        raise ValueError(f"count {n} out of range for buffer of {keys.shape[0]}")
    mk = _key_view(keys, n, bit_count, total_order, descending, bf16_bits)
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
                     descending: bool = False, bf16_bits: bool = False) -> bool:
    """Adjacent-pair order check over the sorted-by key view (bijection,
    mask, then flip — exactly the sort's key pipeline)."""
    keys = np.asarray(keys)
    n = keys.shape[0] if count is None else int(count)
    u = _key_view(keys, n, bit_count, total_order, descending, bf16_bits)
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
