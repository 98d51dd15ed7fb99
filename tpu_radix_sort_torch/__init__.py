"""tpu_radix_sort_torch — the PyTorch/CUDA port of tpu_radix_sort.

Same public surface and byte-exact outputs as the JAX package, for the
slices ported so far (ROADMAP.md): the flat single-device sort of 32-bit
keys through a hand-written bitonic network (``csrc/bitonic.cu``) and the
order check (``csrc/disorder.cu``). Tensors run where they lie; numpy input
goes to the CUDA card unless ``device=`` says otherwise.
"""
from .api import (
    RadixSortBufferKernel,
    RadixSortKernel,
    RadixSortPackedKernel,
    RadixSortTextureKernel,
)
from .ops.checksort import disorder_count, is_sorted
from .ops.sort import argsort, sort, sort_packed

__version__ = "0.1.0"

__all__ = [
    "sort",
    "argsort",
    "sort_packed",
    "is_sorted",
    "disorder_count",
    "RadixSortKernel",
    "RadixSortBufferKernel",
    "RadixSortPackedKernel",
    "RadixSortTextureKernel",
    "__version__",
]
