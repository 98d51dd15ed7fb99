"""Port parity of the prefix scan (kernel K4's plain version on the CPU):
`prefix_sum` / `PrefixSumKernel` byte-exact against the JAX package (its
Pallas scan in interpret mode) and the numpy golden, tolerance 0 (integer
work). Two JAX compilations; everything else is held against golden."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_radix_sort as jtrs
import tpu_radix_sort_torch as trt
from tpu_radix_sort_torch.models.golden import golden_prefix_sum
from tpu_radix_sort_torch.ops import scan


def _items(seed, n, dtype):
    """Large u32 values, so sums wrap many times, viewed as `dtype`."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    u[:3] = 0xFFFFFFFF
    return u.view(dtype)


def _inclusive(x, count):
    """Inclusive golden: exclusive plus the item, u32 wraparound."""
    want = golden_prefix_sum(x, count=count)
    head = want[:count].view(np.uint32) + x[:count].view(np.uint32)
    want[:count] = head.view(x.dtype)
    return want


def _same(got, want):
    g = got.numpy()
    return g.dtype == want.dtype and np.array_equal(g.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype,inclusive", [(np.uint32, False), (np.int32, True)])
def test_prefix_sum_matches_jax(dtype, inclusive):
    x = _items(0, 3000, dtype)
    count = 2000
    want = np.asarray(jtrs.prefix_sum(jnp.asarray(x), count=count, inclusive=inclusive))
    got = trt.prefix_sum(x, count=count, inclusive=inclusive, device="cpu")
    assert _same(got, want)
    gold = _inclusive(x, count) if inclusive else golden_prefix_sum(x, count=count)
    assert _same(got, gold)
    assert np.array_equal(got.numpy()[count:], x[count:])


@pytest.mark.parametrize("dtype", [np.uint32, np.int32])
@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("n,count", [(1, None), (2, 1), (4095, None), (4097, 4096),
                                     (3 * 4096 + 5, None), (777, 0)])
def test_prefix_sum_matches_golden(dtype, inclusive, n, count):
    x = _items(n, n, dtype)
    c = n if count is None else count
    want = _inclusive(x, c) if inclusive else golden_prefix_sum(x, count=c)
    got = trt.prefix_sum(torch.from_numpy(x), count=count, inclusive=inclusive)
    assert _same(got, want)


def test_wraparound_and_tensor_policy():
    x = np.array([0xFFFFFFFF, 0xFFFFFFFF, 5, 7], dtype=np.uint32)
    got = trt.prefix_sum(x, device="cpu")
    assert got.tolist() == [0, 0xFFFFFFFF, 0xFFFFFFFE, 3]
    t = torch.from_numpy(x)
    same = trt.prefix_sum(t, count=0)
    assert torch.equal(same, t) and same.data_ptr() != t.data_ptr()
    assert trt.prefix_sum(np.zeros(0, np.int32), device="cpu").shape == (0,)
    # the plain scan of a 1-D int32 view, the bits K4 works on
    v = torch.from_numpy(x.view(np.int32))
    assert scan.scan_plain(v, inclusive=True).view(torch.uint32).tolist() == [
        0xFFFFFFFF, 0xFFFFFFFE, 3, 10]


def test_prefix_sum_kernel_class():
    x = _items(5, 5000, np.uint32)
    kern = trt.PrefixSumKernel(count=4000, device="cpu")
    assert kern.compile() is kern
    assert _same(kern.dispatch(x), golden_prefix_sum(x, count=4000))
    inc = trt.PrefixSumKernel(count=5000, inclusive=True, avoid_bank_conflicts=True,
                              device="cpu")
    assert _same(inc.dispatch(x.view(np.int32)), _inclusive(x.view(np.int32), 5000))
    with pytest.raises(TypeError):
        trt.PrefixSumKernel(count=8, mesh=object())
    with pytest.raises(ValueError):
        trt.PrefixSumKernel(count=-1)


def test_prefix_sum_kernel_axis_name_matches_jax():
    """`PrefixSumKernel(count=10, axis_name="x")`: JAX's class takes the
    keyword with or without a mesh, and so does the port's."""
    x = _items(7, 64, np.uint32)
    want = np.asarray(jtrs.PrefixSumKernel(count=10, axis_name="x").dispatch(jnp.asarray(x)))
    got = trt.PrefixSumKernel(count=10, axis_name="x", device="cpu").dispatch(x)
    assert _same(got, want)
    assert _same(got, golden_prefix_sum(x, count=10))


def test_input_errors_match_jax_types():
    cases = [
        (TypeError, lambda: trt.prefix_sum(np.zeros(8, np.float32), device="cpu")),
        (TypeError, lambda: trt.prefix_sum(np.zeros(8, np.int64), device="cpu")),
        (ValueError, lambda: trt.prefix_sum(np.zeros((2, 2), np.uint32), device="cpu")),
        (ValueError, lambda: trt.prefix_sum(np.zeros(8, np.uint32), count=9, device="cpu")),
        (ValueError, lambda: trt.prefix_sum(np.zeros(8, np.uint32), count=-1, device="cpu")),
        (TypeError, lambda: trt.prefix_sum(np.zeros(8, np.uint32), device="cpu",
                                           mesh=object())),
        (TypeError, lambda: scan.scan_kernel(torch.zeros(8, dtype=torch.int64))),
        (ValueError, lambda: scan.scan_kernel(torch.zeros((2, 4), dtype=torch.int32))),
    ]
    for exc, fn in cases:
        with pytest.raises(exc):
            fn()
    for exc, fn in [
        (TypeError, lambda: jtrs.prefix_sum(jnp.zeros(8, jnp.float32))),
        (ValueError, lambda: jtrs.prefix_sum(jnp.zeros((2, 2), jnp.uint32))),
        (ValueError, lambda: jtrs.prefix_sum(jnp.zeros(8, jnp.uint32), count=9)),
    ]:
        with pytest.raises(exc):
            fn()
