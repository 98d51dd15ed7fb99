"""tpu_radix_sort_torch — the PyTorch/CUDA port of tpu_radix_sort.

Same public surface and byte-exact outputs as the JAX package, for the
slices ported so far (ROADMAP.md): the flat single-device sort of 16-, 32-
and 64-bit keys through a hand-written bitonic network (``csrc/bitonic.cu``)
or, with ``method='radix'``, the 4-way LSD radix sort (``csrc/radix.cu``,
``csrc/scan.cu``); the order check of one u32 column or of the (hi, lo)
pair of 64-bit keys (``csrc/disorder.cu``); the prefix sum
(``csrc/scan.cu``); and the batched (per-row) and segmented sorts, through
the bitonic network's row-local schedule and a composite (segment, key)
network whose segment ids come from the scan. Tensors run where they lie; numpy input goes to the
CUDA card unless ``device=`` says otherwise (bfloat16 crosses as its bits,
``utils/interop.py``).

Every entry point that takes ``mesh=`` (a
``torch.distributed.device_mesh.DeviceMesh``) runs the distributed path of
``parallel/``: each rank passes its shard, `count` is global, and each
rank gets its shard of the result. :func:`mesh_sort` and
:func:`exchange_sort` are the two strategies of the distributed sort.
"""
from .api import (
    PrefixSumKernel,
    RadixSortBufferKernel,
    RadixSortKernel,
    RadixSortPackedKernel,
    RadixSortTextureKernel,
)
from .ops.batched import argsort_batched, sort_batched
from .ops.checksort import disorder_count, is_sorted
from .ops.scan import prefix_sum
from .ops.segmented import argsort_segments, sort_segments
from .ops.sort import argsort, sort, sort_packed
from .parallel import exchange_sort, mesh_sort

__version__ = "0.1.0"

__all__ = [
    "sort",
    "argsort",
    "sort_packed",
    "sort_batched",
    "argsort_batched",
    "sort_segments",
    "argsort_segments",
    "is_sorted",
    "disorder_count",
    "prefix_sum",
    "RadixSortKernel",
    "RadixSortBufferKernel",
    "RadixSortPackedKernel",
    "RadixSortTextureKernel",
    "PrefixSumKernel",
    "mesh_sort",
    "exchange_sort",
    "__version__",
]
