"""Shared helpers for the sort engines: key transforms, padding, tiling math.

PyTorch counterpart of ``tpu_radix_sort/ops/common.py``.

Storage convention: torch's ``uint32`` lacks ``+``, ``-``, ``>>``, ``>``,
``flip`` and ``searchsorted``, so inside the engines a u32 bit pattern rides
in a ``torch.int32`` tensor with the same bits. Unsigned order on that
storage is the signed order of the pattern XOR 0x80000000 (``bias_i32``).
Every function here that returns a "u32" column returns such an int32
tensor; the public functions convert at their boundary with ``.view``.

Key widths: 32-bit keys are one such column; 16-bit keys (uint16, int16,
float16, bfloat16) widen their u16 bit pattern into the low half of one;
64-bit keys (uint64, int64, float64) split into an (hi, lo) column pair,
whose lexicographic order is the u64 order. ``uint64 >> k`` is not
implemented in torch, so the split shifts the int64 view: the arithmetic
shift is harmless once the result is cut to 32 bits.
"""
from __future__ import annotations

import torch

# Sentinel that sorts after every real key (ascending): all-ones.
SENTINEL_U32 = 0xFFFFFFFF
# The sign bit: XOR with it maps unsigned order onto signed int32 order.
SIGN_I32 = -(1 << 31)
# The same for the int64 view of a u64 pattern.
SIGN_I64 = -(1 << 63)
# Longest sort: indices and positions stay u32 in the kernels.
MAX_LENGTH = 1 << 31

KEY_DTYPES_32 = (torch.uint32, torch.float32, torch.int32)
KEY_DTYPES_16 = (torch.uint16, torch.int16, torch.float16, torch.bfloat16)
KEY_DTYPES_64 = (torch.uint64, torch.int64, torch.float64)
SUPPORTED_KEY_DTYPES = KEY_DTYPES_32 + KEY_DTYPES_16 + KEY_DTYPES_64


def i32(u: int) -> int:
    """The int32 value whose bits equal the u32 value `u`."""
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= (1 << 31) else u


def bias_i32(u: torch.Tensor) -> torch.Tensor:
    """Signed view of a u32 pattern stored in int32: compare these with
    ``<``/``>`` to compare the patterns as unsigned."""
    return u ^ SIGN_I32


def check_key_dtype(dtype) -> None:
    """Raise for a key dtype the sort does not take."""
    if dtype not in SUPPORTED_KEY_DTYPES:
        raise TypeError(
            f"unsupported key dtype {dtype}; expected one of {SUPPORTED_KEY_DTYPES}"
        )


def is_16bit_key_dtype(dtype) -> bool:
    return dtype in KEY_DTYPES_16


def is_64bit_key_dtype(dtype) -> bool:
    return dtype in KEY_DTYPES_64


def native_key_bits(dtype) -> int:
    """Meaningful key-bit width of a supported dtype (16, 32 or 64): the
    default and maximum `bit_count` for that dtype."""
    if is_16bit_key_dtype(dtype):
        return 16
    if is_64bit_key_dtype(dtype):
        return 64
    return 32


def mesh_axis(mesh, axis_name: str):
    """(process group, size D, this rank's index) of the `axis_name` dim of
    a ``torch.distributed.device_mesh.DeviceMesh``: the counterpart of a
    ``jax.sharding.Mesh`` axis for the multi-device layer
    (``parallel/``). Raises TypeError for any other `mesh`."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh, got "
            f"{type(mesh).__name__}"
        )
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"axis_name {axis_name!r} is not a dim of the mesh {names}")
    return (mesh.get_group(axis_name), mesh.size(names.index(axis_name)),
            mesh.get_local_rank(axis_name))


def _u16_pattern(keys: torch.Tensor) -> torch.Tensor:
    """16-bit dtype -> its u16 bit pattern, widened into an int32 lane."""
    return keys.view(torch.int16).to(torch.int32) & 0xFFFF


def _from_u16_pattern(u: torch.Tensor, dtype) -> torch.Tensor:
    """Low 16 bits of an int32 lane -> a tensor of the 16-bit `dtype`
    (the int16 cast keeps the low half)."""
    return u.to(torch.int16).view(dtype)


def to_sortable_u32(keys: torch.Tensor) -> torch.Tensor:
    """Reinterpret keys as the u32 bit pattern the reference orders by.

    uint32: identity. float32/int32: reinterpret bits (the reference's
    contract, correct for non-negative values). 16-bit dtypes widen their
    u16 bit pattern into the low half of the lane. Use
    :func:`to_total_order_u32` for a true total order on signed values.
    """
    if keys.dtype in KEY_DTYPES_32:
        return keys.view(torch.int32)
    if keys.dtype in KEY_DTYPES_16:
        return _u16_pattern(keys)
    raise TypeError(f"unsupported key dtype {keys.dtype}")


def from_sortable_u32(u: torch.Tensor, dtype) -> torch.Tensor:
    if dtype in KEY_DTYPES_16:
        return _from_u16_pattern(u, dtype)
    return u.view(dtype)


def to_total_order_u32(keys: torch.Tensor) -> torch.Tensor:
    """Monotone bijection to u32 giving a *total* ascending order.

    float32 uses the sign-flip trick (flip all bits if negative, else flip
    the sign bit); int32 offsets by 2^31 (flips the sign bit). 16-bit dtypes
    apply the same mapping at 16-bit width, in the low half of the lane.
    """
    dt = keys.dtype
    if dt == torch.uint32:
        return keys.view(torch.int32)
    if dt == torch.int32:
        return keys ^ SIGN_I32
    if dt == torch.float32:
        u = keys.view(torch.int32)
        return u ^ torch.where(u < 0, -1, SIGN_I32).to(torch.int32)
    if dt == torch.uint16:
        return _u16_pattern(keys)
    if dt == torch.int16:
        return _u16_pattern(keys) ^ 0x8000
    if dt in (torch.float16, torch.bfloat16):
        u = _u16_pattern(keys)
        return u ^ torch.where(u >= 0x8000, 0xFFFF, 0x8000).to(torch.int32)
    raise TypeError(f"unsupported key dtype {dt}")


def from_total_order_u32(u: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.uint32:
        return u.view(torch.uint32)
    if dtype == torch.int32:
        return u ^ SIGN_I32
    if dtype == torch.float32:
        flip = torch.where(u < 0, SIGN_I32, -1).to(torch.int32)
        return (u ^ flip).view(torch.float32)
    if dtype == torch.uint16:
        return _from_u16_pattern(u, dtype)
    if dtype == torch.int16:
        return _from_u16_pattern(u ^ 0x8000, dtype)
    if dtype in (torch.float16, torch.bfloat16):
        flip = torch.where(u >= 0x8000, 0x8000, 0xFFFF).to(torch.int32)
        return _from_u16_pattern(u ^ flip, dtype)
    raise TypeError(f"unsupported key dtype {dtype}")


def _split_u64(v: torch.Tensor):
    """int64 view of a u64 pattern -> (hi, lo) int32 (u32-pattern) columns.
    Lexicographic unsigned (hi, lo) order == u64 order."""
    return (v >> 32).to(torch.int32), v.to(torch.int32)


def _join_u64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) u32 columns -> the int64 view of the u64 pattern."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)


def to_sortable_u64_cols(keys: torch.Tensor):
    """Bit-pattern order as (hi, lo) u32 columns (the reference's contract
    lifted to 64 bits: float64/int64 ordered by their u64 bit pattern,
    correct for non-negative values)."""
    if keys.dtype not in KEY_DTYPES_64:
        raise TypeError(f"unsupported key dtype {keys.dtype}; expected one of {KEY_DTYPES_64}")
    return _split_u64(keys.view(torch.int64))


def from_sortable_u64_cols(hi, lo, dtype) -> torch.Tensor:
    return _join_u64(hi, lo).view(dtype)


def to_total_order_u64_cols(keys: torch.Tensor):
    """True total ascending order as (hi, lo) u32 columns: int64 by the
    sign-bit offset, float64 by the sign-flip trick (the mapping of
    :func:`to_total_order_u32`, one word wider)."""
    v = keys.view(torch.int64)
    if keys.dtype == torch.uint64:
        return _split_u64(v)
    if keys.dtype == torch.int64:
        return _split_u64(v ^ SIGN_I64)
    if keys.dtype == torch.float64:
        return _split_u64(v ^ torch.where(v < 0, -1, SIGN_I64))
    raise TypeError(f"unsupported key dtype {keys.dtype}")


def from_total_order_u64_cols(hi, lo, dtype) -> torch.Tensor:
    u = _join_u64(hi, lo)
    if dtype == torch.uint64:
        return u.view(dtype)
    if dtype == torch.int64:
        return u ^ SIGN_I64
    if dtype == torch.float64:
        return (u ^ torch.where(u < 0, SIGN_I64, -1)).view(torch.float64)
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
    return _split_u64(values.view(torch.int64))


def values_from_u32_cols(cols, dtype) -> torch.Tensor:
    """Inverse of :func:`values_to_u32_cols` (cols are the sorted columns)."""
    if len(cols) == 1:
        return cols[0].view(dtype)
    return _join_u64(*cols).view(dtype)


def bit_mask(bit_count: int) -> int:
    """u32 mask of the low `bit_count` bits (as a Python int)."""
    return (1 << bit_count) - 1


def bit_mask_cols(bit_count: int):
    """(hi, lo) u32 masks (Python ints) selecting the low `bit_count` of 64
    key bits."""
    lo = 0xFFFFFFFF if bit_count >= 32 else bit_mask(bit_count)
    hi = bit_mask(bit_count - 32) if bit_count > 32 else 0
    return hi, lo


def validate_bit_count(bit_count: int) -> None:
    # reference constraint: multiple of 4 in [4, 32] (README.md:97)
    if not (4 <= bit_count <= 32) or bit_count % 4 != 0:
        raise ValueError(
            f"bit_count must be a multiple of 4 in [4, 32], got {bit_count}"
        )


def validate_bit_count_64(bit_count: int) -> None:
    # 64-bit keys extend the reference constraint to [4, 64]
    if not (4 <= bit_count <= 64) or bit_count % 4 != 0:
        raise ValueError(
            f"bit_count must be a multiple of 4 in [4, 64] for 64-bit keys, "
            f"got {bit_count}"
        )


def validate_bit_count_for(dtype, bit_count: int) -> None:
    """`bit_count` range check scaled to the key dtype's native width
    (16-bit keys: [4, 16]; 32-bit: the reference's [4, 32]; 64-bit: [4, 64])."""
    check_key_dtype(dtype)
    w = native_key_bits(dtype)
    if not (4 <= bit_count <= w) or bit_count % 4 != 0:
        raise ValueError(
            f"bit_count must be a multiple of 4 in [4, {w}] for {dtype} keys, "
            f"got {bit_count}"
        )


def check_args(keys, values, *, bit_count, values_are_ranks, method, name):
    """Validate the arguments the batched and segmented sorts share, as the
    JAX package does. Returns (bit_count, the resolved method)."""
    check_key_dtype(keys.dtype)
    if bit_count is None:
        bit_count = native_key_bits(keys.dtype)
    validate_bit_count_for(keys.dtype, bit_count)
    if values is not None:
        if values.shape != keys.shape:
            raise ValueError("values must match keys shape")
        validate_value_dtype(values)
        if values_are_ranks and values.dtype.itemsize != 4:
            raise ValueError(
                "values_are_ranks requires a 32-bit value dtype (the rank "
                "contract is a single u32 column)"
            )
    if method not in ("auto", "bitonic", "xla"):
        raise ValueError(
            f"{name} supports method in ('auto', 'bitonic', 'xla'); got {method!r}"
        )
    if keys.numel() >= MAX_LENGTH:
        raise ValueError(f"at most 2^31 - 1 keys, got {keys.numel()}")
    return bit_count, "bitonic" if method == "auto" else method


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


def own(t: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """`t`, copied if it is a view into `buf`: a result that would keep an
    engine's whole padded buffer alive gets storage of its own."""
    if t.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr():
        return t.clone()
    return t


def order_cols(keys: torch.Tensor, bit_count: int, *, total_order: bool,
               descending: bool):
    """The columns a sort of the flat keys orders by: (full_cols, mk_cols,
    masked). full_cols: the key's u32 pattern columns, (u,) or (hi, lo)
    (total order if asked). mk_cols: the compare columns, masked to the low
    `bit_count` bits and flipped when `descending`; (lo,) alone for a
    64-bit key with `bit_count` <= 32, whose masked hi is zero. masked:
    whether `bit_count` is below the key's width; when it is not, the
    compare columns are the full ones (their low `bit_count` bits flipped
    when `descending`)."""
    if is_64bit_key_dtype(keys.dtype):
        full = (to_total_order_u64_cols(keys) if total_order
                else to_sortable_u64_cols(keys))
        masked = bit_count < 64
        masks = tuple(map(i32, bit_mask_cols(bit_count)))
    else:
        full = (to_total_order_u32(keys) if total_order else to_sortable_u32(keys),)
        masked = bit_count < native_key_bits(keys.dtype)
        masks = (i32(bit_mask(bit_count)),)
    mk = tuple(c & m for c, m in zip(full, masks)) if masked else full
    if descending:
        mk = tuple(c ^ m for c, m in zip(mk, masks))
    if len(mk) == 2 and bit_count <= 32:
        mk = mk[1:]
    return full, mk, masked


def from_order_cols(cols, dtype, *, total_order: bool) -> torch.Tensor:
    """Keys of `dtype` from their sorted full_cols (inverse of the views
    of :func:`order_cols`)."""
    if is_64bit_key_dtype(dtype):
        if total_order:
            return from_total_order_u64_cols(*cols, dtype)
        return from_sortable_u64_cols(*cols, dtype)
    if total_order:
        return from_total_order_u32(cols[0], dtype)
    return from_sortable_u32(cols[0], dtype)
