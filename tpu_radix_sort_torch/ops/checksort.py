"""Order-check reduction and early-exit gating.

Counterpart of ``tpu_radix_sort/ops/checksort.py`` for 32-bit keys: the
adjacent-pair disorder count ``keys[i] > keys[i+1]`` of the reference's
CheckSort kernels, a fast check over the first FAST_CHECK_ELEMENTS keys that
gates the full check over the rest, and the early exit that skips a sort
whose input is already in order.

Kernel K2 (``csrc/disorder.cu``) counts on the card; :func:`disorder_plain`
is its plain PyTorch version, which a CPU tensor runs. On a CUDA tensor K2
runs at every size: the JAX package's small-size cutoff was a TPU launch-cost
choice.

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


def disorder_kernel(u: torch.Tensor) -> torch.Tensor:
    """K2: adjacent inversions of a 1-D int32 (u32-pattern) tensor, as a
    1-element int32 tensor on the same device holding the u32 count."""
    if not isinstance(u, torch.Tensor) or u.dtype != torch.int32:
        raise TypeError("disorder_kernel takes an int32 tensor of u32 bit patterns")
    if u.dim() != 1 or not u.is_contiguous():
        raise ValueError("disorder_kernel takes one contiguous 1-D tensor")
    if u.shape[0] >= 1 << 32:
        raise ValueError("length must stay below 2^32")
    if u.device.type == "cpu":
        return disorder_plain(u)
    if u.device.type != "cuda":
        raise ValueError(f"unsupported device {u.device}")
    out = torch.zeros(1, dtype=torch.int32, device=u.device)
    _build.DISORDER(u.data_ptr(), u.shape[0], out.data_ptr(),
                    torch.cuda.current_stream(u.device).cuda_stream)
    return out


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


def _check_view(u, count, bit_count, total_order, descending, device):
    u = interop.as_tensor(u, device)
    if u.dim() != 1:
        raise ValueError("keys must be 1-D")
    common.check_key_dtype(u.dtype)
    bit_count = 32 if bit_count is None else bit_count
    common.validate_bit_count_for(u.dtype, bit_count)
    if count is not None:
        count = int(count)
        if not 0 <= count <= u.shape[0]:
            raise ValueError(f"count {count} out of range for buffer of {u.shape[0]}")
        u = u[:count]
    return _as_check_key(u.contiguous(), bit_count, total_order=total_order,
                         descending=descending).contiguous()


def _disorder(u: torch.Tensor) -> torch.Tensor:
    if u.shape[0] < 2:
        return torch.zeros(1, dtype=torch.int32, device=u.device)
    return disorder_kernel(u)


def disorder_count(u, *, count=None, bit_count=None, total_order=False,
                   descending=False, device=None, mesh=None,
                   axis_name="x") -> torch.Tensor:
    """Number of adjacent inversions in the first `count` keys (0 == sorted),
    as a 0-d uint32 tensor on the keys' device.

    Compares the low `bit_count` bits of the u32 bit pattern, like the sort;
    `total_order`/`descending` check under those sort options' key view.
    """
    del axis_name
    common.reject_mesh(mesh)
    v = _check_view(u, count, bit_count, total_order, descending, device)
    return _disorder(v).view(torch.uint32)[0]


def _is_sorted_view(u: torch.Tensor) -> bool:
    n = u.shape[0]
    f = min(n, FAST_CHECK_ELEMENTS)
    # host branch: int() waits for the device
    if int(_disorder(u[:f])) != 0:
        return False
    if f >= n:
        return True
    # include the boundary pair by starting at f - 1
    return int(_disorder(u[f - 1:])) == 0


def is_sorted(u, *, count=None, bit_count=None, total_order=False,
              descending=False, device=None, mesh=None, axis_name="x") -> bool:
    """Fast-gated full order check: only if the first FAST_CHECK_ELEMENTS
    keys are ordered does the check over the rest run (from f - 1, so the
    boundary pair is included). Same key view options as
    :func:`disorder_count`."""
    del axis_name
    common.reject_mesh(mesh)
    return _is_sorted_view(
        _check_view(u, count, bit_count, total_order, descending, device))


def with_early_exit(u_sorted_check: torch.Tensor, passthrough, compute_fn):
    """Return `passthrough` if `u_sorted_check` (the int32 key view the sort
    orders by) is already sorted, else ``compute_fn()``."""
    return passthrough if _is_sorted_view(u_sorted_check) else compute_fn()
