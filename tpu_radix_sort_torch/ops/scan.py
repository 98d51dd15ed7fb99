"""Exclusive/inclusive prefix scan with u32 wraparound (public op).

Counterpart of ``tpu_radix_sort/ops/scan.py``: the reference's
``PrefixSumKernel`` semantics — an exclusive (default) or inclusive scan of
the first `count` elements with u32 wraparound, the rest untouched, uint32
or int32 in and the same dtype out.

Kernel K4 (``csrc/scan.cu``) scans on the card in one launch for every n.
The TPU kernel carried a running sum across a sequential grid; CUDA blocks
run in no order, so K4 is a single-pass scan with decoupled look-back: each
block takes a tile of SCAN_TILE elements by ticket, publishes its sum, and
adds what it finds by looking back over its predecessors' sums. The input
is read once. :func:`scan_plain` is its plain PyTorch version, which a CPU
tensor runs; on a CUDA tensor :func:`scan_kernel` launches K4 or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from ..utils import interop
from . import common

SCAN_TILE = 16384  # elements per CUDA block of K4 (kTile in csrc/scan.cu)
_U32 = 0xFFFFFFFF


def _wrap_i32(s: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 holding the low 32 bits (u32 wraparound)."""
    return (s & _U32).to(torch.int32)


def scan_plain(x: torch.Tensor, *, inclusive: bool = False) -> torch.Tensor:
    """Plain version of K4: the scan of a 1-D int32 (u32-pattern) tensor.

    An int64 ``cumsum`` masked to 32 bits: torch's int32 ``cumsum`` widens
    to int64, and the low 32 bits of the wide sum are the u32 sum.
    """
    w = x.to(torch.int64) & _U32
    s = torch.cumsum(w, 0)
    return _wrap_i32(s if inclusive else s - w)


def _check(x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError("scan_kernel takes an int32 tensor of u32 bit patterns")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("scan_kernel takes one contiguous 1-D tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def scan_kernel(x: torch.Tensor, *, inclusive: bool = False) -> torch.Tensor:
    """K4: the scan of a 1-D int32 (u32-pattern) tensor, as a new tensor on
    the same device. A CPU tensor runs :func:`scan_plain`."""
    _check(x)
    if x.device.type == "cpu":
        return scan_plain(x, inclusive=inclusive)
    out = torch.empty_like(x)
    n = x.shape[0]
    if n:
        # the tiles' look-back descriptors and the ticket, zeroed on the stream
        scratch = torch.zeros(common.cdiv(n, SCAN_TILE) + 1, dtype=torch.int64, device=x.device)
        _build.SCAN(x.data_ptr(), n, out.data_ptr(), int(inclusive), scratch.data_ptr(),
                    torch.cuda.current_stream(x.device).cuda_stream)
    return out


def prefix_sum(items, *, count=None, inclusive=False, block_rows=None, interpret=None,
               device=None, mesh=None, axis_name="x"):
    """Exclusive (default) or inclusive prefix sum of the first `count`
    elements with u32 wraparound; elements at index >= count are returned
    untouched. uint32 or int32 in, a new tensor of the same dtype out.
    `block_rows` and `interpret` (the JAX package's knobs) are accepted and
    ignored. With `mesh=` (a ``DeviceMesh``), `items` is this rank's shard
    of the global array, `count` is global, and the result is this rank's
    shard of the global scan (``parallel/scan.py``)."""
    del block_rows, interpret
    if mesh is not None:
        from ..parallel.scan import mesh_prefix_sum

        return mesh_prefix_sum(items, mesh=mesh, axis_name=axis_name, count=count,
                               inclusive=inclusive, device=device)
    items = interop.as_tensor(items, device)
    if items.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"prefix_sum expects uint32/int32, got {items.dtype}")
    if items.dim() != 1:
        raise ValueError("items must be 1-D")
    n = items.shape[0]
    count = n if count is None else int(count)
    if not 0 <= count <= n:
        raise ValueError(f"count {count} out of range")
    u = items.view(torch.int32)
    if count == 0:
        return items.clone()
    out = scan_kernel(u[:count].contiguous(), inclusive=inclusive)
    if count < n:
        out = torch.cat([out, u[count:]])
    return out.view(items.dtype)
