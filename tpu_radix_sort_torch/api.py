"""Construct-once / dispatch-many kernel classes.

Counterpart of ``tpu_radix_sort/api.py``: the constructor validates the
configuration once; ``dispatch()`` runs the sort. PyTorch runs eagerly, so
``compile()`` is a warm-up call that builds the CUDA kernels and runs the
sort once on a buffer of the configured size.

Class names mirror the reference exports: `RadixSortKernel` (+ alias
`RadixSortBufferKernel`), `RadixSortPackedKernel` (+ alias
`RadixSortTextureKernel`). `PrefixSumKernel` comes with the scan kernel.
"""
from __future__ import annotations

import functools

import torch

from .ops import common
from .ops import sort as sort_ops
from .utils import interop

__all__ = [
    "RadixSortKernel",
    "RadixSortBufferKernel",
    "RadixSortPackedKernel",
    "RadixSortTextureKernel",
]


class RadixSortKernel:
    """Sorts `count` leading elements of a key (and optional value) buffer.

    Options mirror the JAX package's class. `local_shuffle` and
    `avoid_bank_conflicts` are accepted for API compatibility and ignored
    (WGSL micro-optimizations the reference ships disabled). `device` is
    where `compile()` warms up: by default the CUDA card.
    """

    def __init__(
        self,
        *,
        count: int,
        has_values: bool = False,
        bit_count: int | None = None,
        check_order: bool = False,
        total_order: bool = False,
        descending: bool = False,
        values_are_ranks: bool = False,
        key_dtype=torch.uint32,
        value_dtype=torch.uint32,
        method: str = "auto",
        tile: int | None = None,
        local_shuffle: bool = False,
        avoid_bank_conflicts: bool = False,
        mesh=None,
        axis_name: str = "x",
        device=None,
    ):
        del local_shuffle, avoid_bank_conflicts, axis_name  # accepted, ignored
        common.check_key_dtype(key_dtype)
        bit_count = 32 if bit_count is None else bit_count
        common.validate_bit_count(bit_count)
        sort_ops._resolve_method(method)
        common.reject_mesh(mesh)
        self.count = int(count)
        self.has_values = bool(has_values)
        self.bit_count = int(bit_count)
        self.check_order = bool(check_order)
        self.key_dtype = key_dtype
        self.value_dtype = value_dtype
        self.device = device
        self._fn = functools.partial(
            sort_ops.sort,
            count=self.count,
            bit_count=self.bit_count,
            check_order=self.check_order,
            total_order=total_order,
            descending=descending,
            values_are_ranks=values_are_ranks,
            method=method,
            tile=tile,
        )

    def dispatch(self, keys, values=None):
        """Run the sort. Returns keys or (keys, values)."""
        if self.has_values:
            if values is None:
                raise ValueError("kernel was built with has_values=True")
            return self._fn(keys, values, device=self.device)
        if values is not None:
            raise ValueError("kernel was built with has_values=False")
        return self._fn(keys, device=self.device)

    def compile(self, buffer_len=None):
        """Warm-up: build the kernels and sort a zero buffer of
        `buffer_len` (default: count) elements on the kernel's device."""
        n = buffer_len or self.count
        dev = interop.resolve_device(self.device)
        k = torch.zeros(n, dtype=self.key_dtype, device=dev)
        if self.has_values:
            v = torch.arange(n, dtype=torch.int32, device=dev)
            self.dispatch(k, v.view(self.value_dtype) if self.value_dtype.itemsize == 4
                          else v.to(self.value_dtype))
        else:
            self.dispatch(k)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return self


RadixSortBufferKernel = RadixSortKernel


class RadixSortPackedKernel:
    """Sorts packed (key, value) records laid out as [..., 2] u32 tensors
    (the reference's texture kernel: key in .x, value in .y)."""

    def __init__(self, *, count: int, bit_count: int = 32,
                 check_order: bool = False, method: str = "auto", tile=None,
                 device=None):
        common.validate_bit_count(bit_count)
        sort_ops._resolve_method(method)
        self.count = int(count)
        self.device = device
        self._fn = functools.partial(
            sort_ops.sort_packed, count=self.count, bit_count=bit_count,
            check_order=check_order, method=method, tile=tile,
        )

    def dispatch(self, packed):
        return self._fn(packed, device=self.device)


RadixSortTextureKernel = RadixSortPackedKernel
