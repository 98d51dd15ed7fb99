"""Port parity of the order check (kernel K2's plain version on the CPU):
`disorder_count` / `is_sorted` / `with_early_exit` byte-exact against the JAX
package (its Pallas kernel in interpret mode at >= 262,144 elements) and the
numpy golden."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_radix_sort as jtrs
import tpu_radix_sort_torch as trt
from tpu_radix_sort_torch.models.golden import golden_is_sorted
from tpu_radix_sort_torch.ops import checksort


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def test_disorder_count_matches_jax_kernel_path():
    rng = np.random.default_rng(0)
    n = 262_144 + 77  # the JAX package's Pallas path, padded with sentinels
    u = np.sort(_u32(rng, n))
    u[rng.integers(0, n, 300)] = _u32(rng, 300)
    u[-1] = 0  # an inversion at the very end
    want = int(jtrs.disorder_count(jnp.asarray(u)))
    got = trt.disorder_count(u, device="cpu")
    assert got.dtype == torch.uint32 and got.dim() == 0
    assert int(got) == want == int(np.count_nonzero(u[:-1] > u[1:]))


@pytest.mark.parametrize("kw", [
    {}, {"count": 1500}, {"bit_count": 8}, {"total_order": True},
    {"descending": True}, {"bit_count": 12, "descending": True, "count": 2000},
])
def test_key_views_match_jax(kw):
    """float32 against the JAX package (the dtype whose key views differ
    most); every 32-bit dtype against the golden."""
    rng = np.random.default_rng(1)
    u = _u32(rng, 3000)
    for dtype in (np.float32, np.uint32, np.int32):
        k = u.view(dtype)
        srt = np.sort(k)  # numpy's order: ascending values, a total order
        for x in (k, srt, srt[::-1].copy()):
            want_ok = golden_is_sorted(x, **kw)
            assert trt.is_sorted(x, device="cpu", **kw) == want_ok
            count = int(trt.disorder_count(x, device="cpu", **kw))
            assert (count == 0) == want_ok
            if dtype == np.float32:
                assert count == int(jtrs.disorder_count(jnp.asarray(x), **kw))
                assert want_ok == bool(jtrs.is_sorted(jnp.asarray(x), **kw))


@pytest.mark.parametrize("where", [None, 500, 1022, 1023, 2500])
def test_fast_window_gate_and_boundary_pair(where):
    n = 3000
    u = np.arange(n, dtype=np.uint32) * np.uint32(3)
    if where is not None:  # one inversion: pair (where, where + 1)
        u[where + 1] = u[where] - np.uint32(1)
    want = bool(jtrs.is_sorted(jnp.asarray(u)))
    assert want == (where is None)
    assert trt.is_sorted(u, device="cpu") == want
    # the pair (1023, 1024) straddles the fast window: only the rest's
    # check, which starts at f - 1, sees it
    assert checksort.FAST_CHECK_ELEMENTS == 1024


def test_with_early_exit_skips_compute_on_sorted_input():
    calls = []

    def compute():
        calls.append(1)
        return "sorted now"

    srt = torch.arange(5000, dtype=torch.int32)
    assert checksort.with_early_exit(srt, "as is", compute) == "as is"
    assert calls == []
    assert checksort.with_early_exit(srt.flip(0), "as is", compute) == "sorted now"
    assert calls == [1]


def test_tiny_inputs_and_errors():
    for n in (0, 1, 2):
        x = np.zeros(n, np.uint32)
        assert int(trt.disorder_count(x, device="cpu")) == 0
        assert trt.is_sorted(x, device="cpu")
    assert int(trt.disorder_count(np.array([2, 1], np.uint32), device="cpu")) == 1
    with pytest.raises(ValueError):
        trt.disorder_count(np.zeros(8, np.uint32), count=9, device="cpu")
    with pytest.raises(ValueError):
        trt.is_sorted(np.zeros(8, np.uint32), bit_count=7, device="cpu")
    with pytest.raises(ValueError):
        trt.is_sorted(np.zeros((2, 4), np.uint32), device="cpu")
    with pytest.raises(NotImplementedError):
        trt.is_sorted(np.zeros(8, np.uint64), device="cpu")
    with pytest.raises(NotImplementedError):
        trt.disorder_count(np.zeros(8, np.uint32), device="cpu", mesh=object())
    with pytest.raises(TypeError):
        checksort.disorder_kernel(torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        checksort.disorder_kernel(torch.zeros((2, 4), dtype=torch.int32))
