"""The JAX package's `block_rows=` and `interpret=` keywords on every port
entry point whose JAX counterpart takes them, and `axis_name=` on every
entry point: accepted, ignored, and the bytes are the same with them as
without (the column contract makes every output independent of the tile;
`axis_name` names a mesh axis, and without `mesh=` there is none). Plain
versions on the CPU, no JAX call."""
import numpy as np
import pytest
import torch

import tpu_radix_sort_torch as trt

RNG = np.random.default_rng(6)
K = torch.from_numpy(RNG.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32))
V = torch.from_numpy(RNG.integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32))
OFFS = [0, 0, 100, 250, 300]

CALLS = {
    "sort": lambda **kw: trt.sort(K, V, **kw),
    "argsort": lambda **kw: trt.argsort(K, **kw),
    "sort_packed": lambda **kw: trt.sort_packed(torch.stack([K, V], dim=-1), **kw),
    "prefix_sum": lambda **kw: trt.prefix_sum(K, inclusive=True, **kw),
    "is_sorted": lambda **kw: torch.tensor(trt.is_sorted(K, **kw)),
    "disorder_count": lambda **kw: trt.disorder_count(K, **kw),
    "sort_batched": lambda **kw: trt.sort_batched(K.view(3, 100), V.view(3, 100), **kw),
    "argsort_batched": lambda **kw: trt.argsort_batched(K.view(3, 100), **kw),
    "sort_segments": lambda **kw: trt.sort_segments(K, OFFS, V, **kw),
    "argsort_segments": lambda **kw: trt.argsort_segments(K, OFFS, **kw),
    "RadixSortKernel": lambda **kw: trt.RadixSortKernel(
        count=300, has_values=True, **kw).dispatch(K, V),
    "RadixSortPackedKernel": lambda **kw: trt.RadixSortPackedKernel(
        count=300, **kw).dispatch(torch.stack([K, V], dim=-1)),
    "PrefixSumKernel": lambda **kw: trt.PrefixSumKernel(count=200, **kw).dispatch(K),
}


def _bytes(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [o.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes() for o in outs]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_block_rows_and_interpret_are_accepted_and_ignored(name):
    call = CALLS[name]
    want = _bytes(call())
    for kw in ({"block_rows": 8}, {"interpret": True}, {"block_rows": 512, "interpret": False}):
        assert _bytes(call(**kw)) == want, kw


@pytest.mark.parametrize("name", sorted(CALLS))
def test_axis_name_is_accepted_and_ignored(name):
    call = CALLS[name]
    assert _bytes(call(axis_name="x")) == _bytes(call())
