"""Order-check reduction and early-exit gating.

Counterpart of ``tpu_radix_sort/ops/checksort.py``: the adjacent-pair
disorder count ``keys[i] > keys[i+1]`` of the reference's CheckSort kernels,
a fast check over the first FAST_CHECK_ELEMENTS keys that gates the full
check over the rest, and the early exit that skips a sort whose input is
already in order.

Two kernels count on the card, each with its plain PyTorch version beside
it, which a CPU tensor runs:

- K2 (``csrc/disorder.cu`` ``disorder_kernel``, :func:`disorder_plain`):
  one u32 column, the view of 16- and 32-bit keys, and of 64-bit keys
  checked with ``bit_count <= 32``;
- K3 (``csrc/disorder.cu`` ``disorder_cols_kernel``,
  :func:`disorder_cols_plain`): the (hi, lo) column pair of 64-bit keys,
  compared lexicographically.

On a CUDA tensor both run at every size: the JAX package's small-size
cutoff was a TPU launch-cost choice.

The JAX package gates with ``lax.cond`` on the device. Here the gate is a
host branch on the count, which costs one device-to-host sync per gate.
"""
from __future__ import annotations

import torch

from .. import _build
from ..utils import interop
from . import common

# The reference's fast-check window: the first min(count, 4*threads)
# elements with the default 256-thread workgroup.
FAST_CHECK_ELEMENTS = 1024


def disorder_plain(u: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: count of i with u[i] > u[i+1] (unsigned), as a
    1-element int32 tensor holding the u32 count."""
    b = common.bias_i32(u)
    return (b[:-1] > b[1:]).sum(dtype=torch.int64).to(torch.int32).reshape(1)


def disorder_cols_plain(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: count of i with (hi, lo)[i] > (hi, lo)[i+1],
    lexicographic and unsigned, as a 1-element int32 tensor holding the
    u32 count."""
    bh, bl = common.bias_i32(hi), common.bias_i32(lo)
    gt = (bh[:-1] > bh[1:]) | ((hi[:-1] == hi[1:]) & (bl[:-1] > bl[1:]))
    return gt.sum(dtype=torch.int64).to(torch.int32).reshape(1)


def _check_column(u, name: str) -> None:
    if not isinstance(u, torch.Tensor) or u.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 tensors of u32 bit patterns")
    if u.dim() != 1 or not u.is_contiguous():
        raise ValueError(f"{name} takes contiguous 1-D tensors")
    if u.shape[0] >= 1 << 32:
        raise ValueError("length must stay below 2^32")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {u.device}")


def disorder_kernel(u: torch.Tensor) -> torch.Tensor:
    """K2: adjacent inversions of a 1-D int32 (u32-pattern) tensor, as a
    1-element int32 tensor on the same device holding the u32 count."""
    _check_column(u, "disorder_kernel")
    if u.device.type == "cpu":
        return disorder_plain(u)
    out = torch.zeros(1, dtype=torch.int32, device=u.device)
    _build.DISORDER(u.data_ptr(), u.shape[0], out.data_ptr(),
                    torch.cuda.current_stream(u.device).cuda_stream)
    return out


def disorder_cols_kernel(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """K3: adjacent lexicographic inversions of the (hi, lo) column pair
    (1-D int32 u32-pattern tensors of one length, on one device), as a
    1-element int32 tensor on that device holding the u32 count."""
    _check_column(hi, "disorder_cols_kernel")
    _check_column(lo, "disorder_cols_kernel")
    if hi.shape != lo.shape or hi.device != lo.device:
        raise ValueError("hi and lo must have one length and one device")
    if hi.device.type == "cpu":
        return disorder_cols_plain(hi, lo)
    out = torch.zeros(1, dtype=torch.int32, device=hi.device)
    _build.DISORDER_COLS(hi.data_ptr(), lo.data_ptr(), hi.shape[0], out.data_ptr(),
                         torch.cuda.current_stream(hi.device).cuda_stream)
    return out


def _disorder_cols(cols) -> torch.Tensor:
    """Adjacent inversions of the lexicographic column tuple: (u,) through
    K2, (hi, lo) through K3."""
    if cols[0].shape[0] < 2:
        return torch.zeros(1, dtype=torch.int32, device=cols[0].device)
    if len(cols) == 1:
        return disorder_kernel(cols[0])
    return disorder_cols_kernel(*cols)


def disorder_count_cols(cols) -> torch.Tensor:
    """Adjacent inversions of a lexicographic tuple of 1 or 2 int32 columns
    (the u32 and the 64-bit key views), as a 0-d uint32 tensor."""
    return _disorder_cols(cols).view(torch.uint32)[0]


def is_sorted_cols(cols) -> bool:
    """Fast-gated order check of a lexicographic tuple of 1 or 2 int32
    columns: only if the first FAST_CHECK_ELEMENTS rows are ordered does the
    check over the rest run (from f - 1, so the boundary pair is included)."""
    n = cols[0].shape[0]
    f = min(n, FAST_CHECK_ELEMENTS)
    # host branch: int() waits for the device
    if int(_disorder_cols(tuple(c[:f] for c in cols))) != 0:
        return False
    if f >= n:
        return True
    return int(_disorder_cols(tuple(c[f - 1:] for c in cols))) == 0


def _as_check_key(u: torch.Tensor, bit_count: int, *, total_order=False,
                  descending=False) -> torch.Tensor:
    """Keys -> the masked u32 word the sort orders by (the exact `sort`
    key pipeline: bijection, mask, then the descending flip)."""
    u = common.to_total_order_u32(u) if total_order else common.to_sortable_u32(u)
    mask = common.i32(common.bit_mask(bit_count))
    if bit_count < 32:
        u = u & mask
    if descending:
        u = u ^ mask
    return u


def _as_check_key_cols(u: torch.Tensor, bit_count: int, *, total_order=False,
                       descending=False):
    """64-bit keys' check view: masked (hi, lo) u32 columns ((lo,) alone
    when bit_count <= 32, the hi column being all-zero then), with the same
    `total_order`/`descending` view transforms as :func:`_as_check_key`."""
    if total_order:
        hi, lo = common.to_total_order_u64_cols(u)
    else:
        hi, lo = common.to_sortable_u64_cols(u)
    mask_hi, mask_lo = map(common.i32, common.bit_mask_cols(bit_count))
    hi, lo = hi & mask_hi, lo & mask_lo
    if descending:
        hi, lo = hi ^ mask_hi, lo ^ mask_lo
    return (lo,) if bit_count <= 32 else (hi, lo)


def _check_view(u, count, bit_count, total_order, descending, device):
    """Keys -> the column tuple the sort with these options orders by."""
    u = interop.as_tensor(u, device)
    if u.dim() != 1:
        raise ValueError("keys must be 1-D")
    common.check_key_dtype(u.dtype)
    bit_count = common.native_key_bits(u.dtype) if bit_count is None else bit_count
    common.validate_bit_count_for(u.dtype, bit_count)
    if count is not None:
        count = int(count)
        if not 0 <= count <= u.shape[0]:
            raise ValueError(f"count {count} out of range for buffer of {u.shape[0]}")
        u = u[:count]
    u = u.contiguous()
    if common.is_64bit_key_dtype(u.dtype):
        return _as_check_key_cols(u, bit_count, total_order=total_order,
                                  descending=descending)
    return (_as_check_key(u, bit_count, total_order=total_order,
                          descending=descending),)


def disorder_count(u, *, count=None, bit_count=None, total_order=False,
                   descending=False, block_rows=None, interpret=None, device=None,
                   mesh=None, axis_name="x") -> torch.Tensor:
    """Number of adjacent inversions in the first `count` keys (0 == sorted),
    as a 0-d uint32 tensor on the keys' device.

    Compares the low `bit_count` bits (default: the key's width) of the bit
    pattern, like the sort; `total_order`/`descending` check under those
    sort options' key view. 64-bit keys compare (hi, lo) pairs (K3).
    `block_rows` and `interpret` are accepted and ignored. With `mesh=` (a
    ``DeviceMesh``), `u` is this rank's shard of the global keys, `count`
    is global, and every rank gets the count of the global array
    (``parallel/check.py``).
    """
    del block_rows, interpret
    if mesh is not None:
        from ..parallel.check import mesh_disorder_count

        return mesh_disorder_count(u, mesh=mesh, axis_name=axis_name, count=count,
                                   bit_count=bit_count, total_order=total_order,
                                   descending=descending, device=device)
    return disorder_count_cols(
        _check_view(u, count, bit_count, total_order, descending, device))


def is_sorted(u, *, count=None, bit_count=None, total_order=False,
              descending=False, block_rows=None, interpret=None, device=None,
              mesh=None, axis_name="x") -> bool:
    """Fast-gated full order check (:func:`is_sorted_cols`) under the same
    key view options as :func:`disorder_count`, and over a mesh as it."""
    del block_rows, interpret
    if mesh is not None:
        from ..parallel.check import mesh_is_sorted

        return mesh_is_sorted(u, mesh=mesh, axis_name=axis_name, count=count,
                              bit_count=bit_count, total_order=total_order,
                              descending=descending, device=device)
    return is_sorted_cols(
        _check_view(u, count, bit_count, total_order, descending, device))


def with_early_exit(u_sorted_check: torch.Tensor, passthrough, compute_fn):
    """Return `passthrough` if `u_sorted_check` (the int32 key view the sort
    orders by) is already sorted, else ``compute_fn()``."""
    return passthrough if is_sorted_cols((u_sorted_check,)) else compute_fn()
