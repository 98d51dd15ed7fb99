"""The plain references against NumPy at small sizes, and their controls
failing the comparison."""
import numpy as np
import pytest
import torch

from perfbench.harness import generate
from perfbench.reference import flat_pairs, mesh_pairs, segmented_keys


def _u32(a):
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).view(np.int32).copy()).view(torch.uint32)


def _np(t):
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("high", [16, 2**32])
def test_flat_reference_is_numpys_stable_sort(high):
    rng = np.random.default_rng(high)
    keys = rng.integers(0, high, 5000, dtype=np.uint64).astype(np.uint32)
    keys[:3] = [0xFFFFFFFF, 0x80000000, 0]
    values = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    inputs = {"keys": _u32(keys), "values": _u32(values)}
    got = flat_pairs.expected(inputs)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(_np(got["keys"]), keys[order])
    assert np.array_equal(_np(got["values"]), values[order])
    assert flat_pairs.judge(inputs, got) == {"key_mismatches": 0, "value_mismatches": 0}
    assert mesh_pairs.judge is flat_pairs.judge


def test_segmented_reference_is_numpys_lexsort():
    rng = np.random.default_rng(1)
    n = 6000
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    sizes = generate.segment_sizes(n, {"layout": "zipf", "count": 50, "exponent": 1.3,
                                       "sizes_seed": 2}, 3, 0)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    inputs = {"keys": _u32(keys), "offsets": torch.from_numpy(offsets)}
    seg = np.repeat(np.arange(sizes.size), sizes)
    want = keys[np.lexsort((keys, seg))]
    assert np.array_equal(_np(segmented_keys.expected(inputs)["keys"]), want)
    assert segmented_keys.judge(inputs, {"keys": _u32(want)}) == {"key_mismatches": 0}


def test_mismatches_counts_positions_and_a_wrong_shape_counts_all():
    a = _u32(np.arange(10))
    b = a.clone()
    b.view(torch.int32)[[2, 7]] += 1
    assert flat_pairs.mismatches(b, a) == 2
    assert flat_pairs.mismatches(a[:5], a) == 10
    assert flat_pairs.mismatches(a.view(torch.int32).to(torch.int64), a) == 10


def test_flat_control_fails_the_comparison():
    n = 1 << 16  # keys of 10 bits: many equal keys, whose order the control reverses
    keys = torch.randint(0, 1 << 10, (n,), generator=torch.Generator().manual_seed(11))
    inputs = {"keys": keys.to(torch.int32).view(torch.uint32),
              "values": torch.arange(n, dtype=torch.int32).view(torch.uint32)}
    got = flat_pairs.judge(inputs, flat_pairs.control(inputs))
    assert got["key_mismatches"] == 0 and got["value_mismatches"] > 1000


def test_segmented_control_fails_the_comparison():
    inputs = generate.global_inputs(
        {"n": 1 << 18, "key_dtype": "uint32"},
        {"keys": {"distribution": "uniform"}, "segments": {"layout": "equal", "count": 16}},
        11, 0, torch.device("cpu"))
    assert segmented_keys.judge(inputs, segmented_keys.control(inputs))["key_mismatches"] > 0
