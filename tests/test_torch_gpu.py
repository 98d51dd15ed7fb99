"""K1 and K2 on the CUDA card against their plain PyTorch versions.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips where
there is none. On a CUDA machine without JAX, run them apart from the rest of
the suite (tests/conftest.py imports JAX):

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""
import numpy as np
import pytest
import torch

import tpu_radix_sort_torch as trt
from tpu_radix_sort_torch import _build
from tpu_radix_sort_torch.models.golden import golden_sort
from tpu_radix_sort_torch.ops import bitonic, checksort
from tpu_radix_sort_torch.ops import sort as sort_mod

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _columns(rng, n_arr, n_keys, n):
    """Random (n_arr, n) int32 columns: a low-entropy key (duplicates) and,
    below it, a unique tie so sorted tuples are distinct."""
    x = rng.integers(-2**31, 2**31, (n_arr, n), dtype=np.int64).astype(np.int32)
    x[0] = rng.integers(0, 64, n).astype(np.int32)
    if n_keys >= 2:
        x[n_keys - 1] = rng.permutation(n).astype(np.int32)
    return torch.from_numpy(x)


@pytest.mark.parametrize("n_arr,n_keys", [
    (1, 1), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3), (5, 2), (5, 3),
])
def test_bitonic_kernels_match_plain(cuda, n_arr, n_keys):
    rng = np.random.default_rng(10 * n_arr + n_keys)
    n, tile = 1 << 14, 256
    x = _columns(rng, n_arr, n_keys, n).to(cuda)
    before = _build.launch_counts()
    for call in bitonic.sort_schedule(n, tile):
        got = bitonic.run_schedule(x.clone(), [call], n_keys=n_keys, tile=tile)
        stages = call[1] if call[0] == "tile" else [call[1:]]
        want = bitonic.stages_plain(x.clone(), stages, n_keys)
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
        x = got
    after = _build.launch_counts()
    assert after["bitonic_tile_kernel"] > before["bitonic_tile_kernel"]
    assert after["bitonic_global_stage_kernel"] > before["bitonic_global_stage_kernel"]
    keys = x[:n_keys].cpu().numpy().view(np.uint32)
    # sorted key tuples: a stable lexsort leaves them where they are
    assert np.array_equal(np.lexsort(keys[::-1]), np.arange(n))


@pytest.mark.parametrize("kind", ["sorted", "reversed", "random", "short"])
def test_disorder_kernel_matches_plain(cuda, kind):
    rng = np.random.default_rng(7)
    n = 3 if kind == "short" else (1 << 20) + 3
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "sorted":
        u.sort()
    elif kind == "reversed":
        u = np.sort(u)[::-1].copy()
    t = torch.from_numpy(u.view(np.int32)).to(cuda)
    before = _build.DISORDER.launches
    got = checksort.disorder_kernel(t)
    assert _build.DISORDER.launches == before + 1
    want = checksort.disorder_plain(t)
    assert torch.equal(got, want)
    assert int(got) == int(np.count_nonzero(u[:-1] > u[1:]))


def test_sort_on_card_matches_golden(cuda, monkeypatch):
    monkeypatch.setattr(sort_mod, "SPLIT_MIN_N", 1 << 12)
    rng = np.random.default_rng(3)
    for n in (5000, 100_000):
        k = rng.integers(0, n // 8, n, dtype=np.uint64).astype(np.uint32)
        k[rng.integers(0, n, 50)] = 0xFFFFFFFF
        v = np.arange(n, dtype=np.uint32)
        for kw in ({}, {"values_are_ranks": True}, {"bit_count": 8},
                   {"descending": True}, {"count": n // 3}, {"check_order": True}):
            ok, ov = trt.sort(k, v, device=cuda, tile=512, **kw)
            gk, gv = golden_sort(k, v, **{a: b for a, b in kw.items()
                                          if a in ("bit_count", "descending", "count")})
            assert np.array_equal(ok.cpu().numpy(), gk), (n, kw)
            assert np.array_equal(ov.cpu().numpy(), gv), (n, kw)
        assert np.array_equal(trt.sort(k, device=cuda).cpu().numpy(), golden_sort(k))
        assert trt.is_sorted(np.sort(k), device=cuda)
        assert not trt.is_sorted(k, device=cuda)
