"""Shared helpers for the sort engines: key transforms, padding, tiling math.

PyTorch counterpart of ``tpu_radix_sort/ops/common.py``, 32-bit key surface.

Storage convention: torch's ``uint32`` lacks ``+``, ``-``, ``>>``, ``>``,
``flip`` and ``searchsorted``, so inside the engines a u32 bit pattern rides
in a ``torch.int32`` tensor with the same bits. Unsigned order on that
storage is the signed order of the pattern XOR 0x80000000 (``bias_i32``).
Every function here that returns a "u32" column returns such an int32
tensor; the public functions convert at their boundary with ``.view``.
"""
from __future__ import annotations

import torch

# Sentinel that sorts after every real key (ascending): all-ones.
SENTINEL_U32 = 0xFFFFFFFF
# The sign bit: XOR with it maps unsigned order onto signed int32 order.
SIGN_I32 = -(1 << 31)

SUPPORTED_KEY_DTYPES = (torch.uint32, torch.float32, torch.int32)
# Key dtypes of the JAX package that later slices of the port add
# (16-bit keys widened into a u32 lane; 64-bit keys as (hi, lo) columns).
LATER_KEY_DTYPES = (
    torch.uint16, torch.int16, torch.float16, torch.bfloat16,
    torch.uint64, torch.int64, torch.float64,
)


def i32(u: int) -> int:
    """The int32 value whose bits equal the u32 value `u`."""
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= (1 << 31) else u


def bias_i32(u: torch.Tensor) -> torch.Tensor:
    """Signed view of a u32 pattern stored in int32: compare these with
    ``<``/``>`` to compare the patterns as unsigned."""
    return u ^ SIGN_I32


def check_key_dtype(dtype) -> None:
    """Raise for a key dtype this slice of the port does not sort."""
    if dtype in SUPPORTED_KEY_DTYPES:
        return
    if dtype in LATER_KEY_DTYPES:
        raise NotImplementedError(
            f"{dtype} keys are not ported yet: 16- and 64-bit keys come with "
            "the 'Wider dtypes' slice of ROADMAP.md (Queue 1, item 6)"
        )
    raise TypeError(
        f"unsupported key dtype {dtype}; expected one of {SUPPORTED_KEY_DTYPES}"
    )


def reject_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: distributed sorts and checks come with "
            "the 'parallel/ on torch.distributed' slice of ROADMAP.md "
            "(Queue 1, item 9)"
        )


def to_sortable_u32(keys: torch.Tensor) -> torch.Tensor:
    """Reinterpret keys as the u32 bit pattern the reference orders by.

    uint32: identity. float32/int32: reinterpret bits (the reference's
    contract, correct for non-negative values). Use
    :func:`to_total_order_u32` for a true total order on signed values.
    """
    if keys.dtype in SUPPORTED_KEY_DTYPES:
        return keys.view(torch.int32)
    raise TypeError(f"unsupported key dtype {keys.dtype}")


def from_sortable_u32(u: torch.Tensor, dtype) -> torch.Tensor:
    return u.view(dtype)


def to_total_order_u32(keys: torch.Tensor) -> torch.Tensor:
    """Monotone bijection to u32 giving a *total* ascending order.

    float32 uses the sign-flip trick (flip all bits if negative, else flip
    the sign bit); int32 offsets by 2^31 (flips the sign bit).
    """
    if keys.dtype == torch.uint32:
        return keys.view(torch.int32)
    if keys.dtype == torch.int32:
        return keys ^ SIGN_I32
    if keys.dtype == torch.float32:
        u = keys.view(torch.int32)
        return u ^ torch.where(u < 0, -1, SIGN_I32).to(torch.int32)
    raise TypeError(f"unsupported key dtype {keys.dtype}")


def from_total_order_u32(u: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.uint32:
        return u.view(torch.uint32)
    if dtype == torch.int32:
        return u ^ SIGN_I32
    if dtype == torch.float32:
        flip = torch.where(u < 0, SIGN_I32, -1).to(torch.int32)
        return (u ^ flip).view(torch.float32)
    raise TypeError(f"unsupported key dtype {dtype}")


def validate_value_dtype(values: torch.Tensor) -> None:
    """Values ride the engines as u32 columns: one for 4-byte dtypes, an
    (hi, lo) pair for 8-byte dtypes."""
    if values.dtype.itemsize not in (4, 8) or values.dtype.is_complex:
        raise TypeError(
            f"values must be a 32- or 64-bit dtype, got {values.dtype}"
        )


def values_to_u32_cols(values: torch.Tensor):
    """Payload -> tuple of u32 (int32-stored) columns: (v,) for 4-byte
    dtypes, the (hi, lo) bit-pattern pair for 8-byte dtypes."""
    if values.dtype.itemsize == 4:
        return (values.view(torch.int32),)
    v = values.view(torch.int64)
    return (v >> 32).to(torch.int32), v.to(torch.int32)


def values_from_u32_cols(cols, dtype) -> torch.Tensor:
    """Inverse of :func:`values_to_u32_cols` (cols are the sorted columns)."""
    if len(cols) == 1:
        return cols[0].view(dtype)
    hi, lo = cols
    joined = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
    return joined.view(dtype)


def bit_mask(bit_count: int) -> int:
    """u32 mask of the low `bit_count` bits (as a Python int)."""
    return (1 << bit_count) - 1


def validate_bit_count(bit_count: int) -> None:
    # reference constraint: multiple of 4 in [4, 32] (README.md:97)
    if not (4 <= bit_count <= 32) or bit_count % 4 != 0:
        raise ValueError(
            f"bit_count must be a multiple of 4 in [4, 32], got {bit_count}"
        )


def validate_bit_count_for(dtype, bit_count: int) -> None:
    """`bit_count` range check for a 32-bit key dtype: [4, 32], step 4."""
    check_key_dtype(dtype)
    if not (4 <= bit_count <= 32) or bit_count % 4 != 0:
        raise ValueError(
            f"bit_count must be a multiple of 4 in [4, 32] for {dtype} keys, "
            f"got {bit_count}"
        )


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def pad_to(x: torch.Tensor, n: int, fill: int) -> torch.Tensor:
    """Pad a 1-D int32 column to length n with the u32 value `fill`
    (no-op if already length n)."""
    if x.shape[0] == n:
        return x
    pad = torch.full((n - x.shape[0],), i32(fill), dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])
