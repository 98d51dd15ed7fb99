"""Construct-once / dispatch-many kernel classes.

Counterpart of ``tpu_radix_sort/api.py``: the constructor validates the
configuration once; ``dispatch()`` runs the sort. PyTorch runs eagerly, so
``compile()`` is a warm-up call that builds the CUDA kernels and runs the
sort once on a buffer of the configured size.

Class names mirror the reference exports: `RadixSortKernel` (+ alias
`RadixSortBufferKernel`), `RadixSortPackedKernel` (+ alias
`RadixSortTextureKernel`), `PrefixSumKernel`.
"""
from __future__ import annotations

import functools

import torch

from .ops import common
from .ops import scan as scan_ops
from .ops import sort as sort_ops
from .utils import interop

__all__ = [
    "RadixSortKernel",
    "RadixSortBufferKernel",
    "RadixSortPackedKernel",
    "RadixSortTextureKernel",
    "PrefixSumKernel",
]


class RadixSortKernel:
    """Sorts `count` leading elements of a key (and optional value) buffer.

    Options mirror the JAX package's class. `local_shuffle` and
    `avoid_bank_conflicts` are accepted for API compatibility and ignored
    (WGSL micro-optimizations the reference ships disabled), and so are the
    JAX package's `block_rows` and `interpret`. `device` is
    where `compile()` warms up: by default the CUDA card.

    With `mesh=` (a ``DeviceMesh``) and `axis_name=`, one instance on each
    rank is a distributed sort: `count` is global, `dispatch` takes this
    rank's shard and returns its shard of the result, and `method` is
    'auto', 'mesh' or 'exchange' (``ops/sort.py`` ``sort``).
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
        block_rows=None,
        interpret=None,
        local_shuffle: bool = False,
        avoid_bank_conflicts: bool = False,
        mesh=None,
        axis_name: str = "x",
        device=None,
    ):
        # accepted, ignored
        del block_rows, interpret, local_shuffle, avoid_bank_conflicts
        common.check_key_dtype(key_dtype)
        # bit_count defaults to 64 for 64-bit keys, whose range is [4, 64],
        # and to 32 otherwise. As in the JAX class, a 16-bit key_dtype also
        # gets 32, which the sort refuses at dispatch (ROADMAP Queue 3).
        wide = common.is_64bit_key_dtype(key_dtype)
        if bit_count is None:
            bit_count = 64 if wide else 32
        if wide:
            common.validate_bit_count_64(bit_count)
        else:
            common.validate_bit_count(bit_count)
        if mesh is None:
            sort_ops._resolve_method(method)
        else:
            sort_ops._resolve_mesh_method(method, common.mesh_axis(mesh, axis_name)[1])
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
            mesh=mesh,
            axis_name=axis_name,
        )
        self.mesh, self.axis_name = mesh, axis_name

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
        `buffer_len` (default: count) elements on the kernel's device; with
        `mesh=`, every rank calls it, and each sorts its shard of the buffer."""
        n = _shard_len(buffer_len or self.count, self.mesh, self.axis_name)
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
    (the reference's texture kernel: key in .x, value in .y). The JAX
    package's `block_rows` and `interpret`, and `axis_name` as every other
    entry point takes it, are accepted and ignored."""

    def __init__(self, *, count: int, bit_count: int = 32,
                 check_order: bool = False, method: str = "auto", tile=None,
                 block_rows=None, interpret=None, axis_name: str = "x", device=None):
        del block_rows, interpret, axis_name  # accepted, ignored
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


def _shard_len(n: int, mesh, axis_name: str) -> int:
    """This rank's share of a buffer of n elements (all of it without a mesh)."""
    if mesh is None:
        return n
    from .parallel.mesh_sort import shard_length

    _, n_dev, me = common.mesh_axis(mesh, axis_name)
    return shard_length(n, n_dev, me)


class PrefixSumKernel:
    """Exclusive (default) or inclusive prefix sum of the first `count`
    elements of a uint32/int32 buffer, u32 wraparound, the rest untouched
    (the reference's `PrefixSumKernel`). `avoid_bank_conflicts`, `block_rows`
    and `interpret` are accepted for API compatibility and ignored. With
    `mesh=` (a ``DeviceMesh``) and `axis_name=`, `count` is global and
    `dispatch` scans this rank's shard of the global buffer
    (``parallel/scan.py``). `device` is where `compile()` warms up: by
    default the CUDA card.
    """

    def __init__(self, *, count: int, inclusive: bool = False, block_rows=None,
                 interpret=None, avoid_bank_conflicts: bool = False, mesh=None,
                 axis_name: str = "x", device=None):
        # accepted, ignored
        del block_rows, interpret, avoid_bank_conflicts
        if mesh is not None:
            common.mesh_axis(mesh, axis_name)
        self.count = int(count)
        if self.count < 0:
            raise ValueError(f"count must be >= 0, got {self.count}")
        self.device = device
        self.mesh, self.axis_name = mesh, axis_name
        self._fn = functools.partial(scan_ops.prefix_sum, count=self.count,
                                     inclusive=inclusive, mesh=mesh, axis_name=axis_name)

    def dispatch(self, items):
        """Run the scan. Returns a new tensor of the items' dtype."""
        return self._fn(items, device=self.device)

    def compile(self, buffer_len=None):
        """Warm-up: build the kernel and scan a zero uint32 buffer of
        `buffer_len` (default: count) elements on the kernel's device."""
        dev = interop.resolve_device(self.device)
        n = _shard_len(buffer_len or self.count, self.mesh, self.axis_name)
        self.dispatch(torch.zeros(n, dtype=torch.uint32, device=dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return self
