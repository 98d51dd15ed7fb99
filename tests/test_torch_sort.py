"""Port parity of the flat sort (the slice as a whole, on the CPU through the
kernels' plain versions): `sort` / `argsort` / `sort_packed` and the kernel
classes, byte-exact against the JAX package (`method="bitonic"`, Pallas in
interpret mode) and the numpy golden, over the hazards of ROADMAP.md."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_radix_sort as jtrs
import tpu_radix_sort_torch as trt
from tpu_radix_sort_torch.models.golden import golden_sort
from tpu_radix_sort_torch.ops import sort as sort_mod
from tpu_radix_sort_torch.runtime.timing import device_time


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _np(t):
    return t.numpy()


def _eq(got, want):
    """Byte equality of a result (tensor or pair) with numpy arrays."""
    if isinstance(want, tuple):
        return all(_eq(g, w) for g, w in zip(got, want))
    g = _np(got)
    return g.dtype == want.dtype and np.array_equal(g.view(np.uint8), want.view(np.uint8))


def _gold_kw(kw):
    return {a: b for a, b in kw.items()
            if a in ("count", "bit_count", "descending", "total_order")}


def test_matches_jax_bitonic_sort():
    rng = np.random.default_rng(0)
    n = 1000  # pads to 1024: sentinels right behind real 0xFFFFFFFF keys
    k = _u32(rng, n, 60)
    k[rng.integers(0, n, 50)] = 0xFFFFFFFF
    v = np.arange(n, dtype=np.uint32)
    jk, jv = jtrs.sort(jnp.asarray(k), jnp.asarray(v), method="bitonic",
                       values_are_ranks=True)
    got = trt.sort(k, v, device="cpu", tile=64, values_are_ranks=True)
    assert _eq(got, (np.asarray(jk), np.asarray(jv)))


def test_broken_rank_promise_matches_jax():
    """values_are_ranks with values that are not an increasing rank: equal
    keys come out ordered by value bits, exactly as in the JAX package."""
    rng = np.random.default_rng(1)
    n = 300
    k = _u32(rng, n, 30)
    v = (np.arange(n, dtype=np.uint32)[::-1] * np.uint32(7)).copy()
    jk, jv = jtrs.sort(jnp.asarray(k), jnp.asarray(v), method="bitonic",
                       values_are_ranks=True)
    got = trt.sort(k, v, device="cpu", values_are_ranks=True)
    assert _eq(got, (np.asarray(jk), np.asarray(jv)))
    order = np.lexsort((v, k))
    assert _eq(got, (k[order], v[order]))
    assert not _eq(got, golden_sort(k, v))


@pytest.mark.parametrize("n", [0, 1, 2, 129])
@pytest.mark.parametrize("kw", [{}, {"values_are_ranks": True}, {"bit_count": 8},
                                {"check_order": True}, {"method": "xla"}])
def test_tiny_sizes(n, kw):
    rng = np.random.default_rng(n)
    k = _u32(rng, n, 10)
    v = np.arange(n, dtype=np.uint32)
    assert _eq(trt.sort(k, v, device="cpu", **kw), golden_sort(k, v, **_gold_kw(kw)))
    if "values_are_ranks" not in kw:
        assert _eq(trt.sort(k, device="cpu", **kw), golden_sort(k, **_gold_kw(kw)))


@pytest.mark.parametrize("kw", [
    {}, {"values_are_ranks": True}, {"bit_count": 4}, {"bit_count": 16},
    {"bit_count": 28}, {"descending": True}, {"count": 777},
    {"count": 777, "bit_count": 8, "descending": True, "values_are_ranks": True},
    {"check_order": True}, {"method": "xla"}, {"method": "xla", "bit_count": 8},
])
def test_options_match_golden(kw):
    """Heavy duplicates and real 0xFFFFFFFF keys beside the sentinel pads;
    keys-only `bit_count` < 32 must carry the full key."""
    rng = np.random.default_rng(2)
    n = 1000
    k = _u32(rng, n, 40) | (_u32(rng, n) & np.uint32(0xFFFFFF00))
    k[rng.integers(0, n, 60)] = 0xFFFFFFFF
    v = np.arange(n, dtype=np.uint32)
    assert _eq(trt.sort(k, v, device="cpu", tile=32, **kw),
               golden_sort(k, v, **_gold_kw(kw)))
    if "values_are_ranks" not in kw:
        assert _eq(trt.sort(k, device="cpu", tile=32, **kw),
                   golden_sort(k, **_gold_kw(kw)))


def test_all_equal_keys_are_stable():
    k = np.full(1500, 42, np.uint32)
    v = np.arange(1500, dtype=np.uint32)[::-1].copy()
    assert _eq(trt.sort(k, v, device="cpu"), (k, v))
    assert _eq(trt.sort(k, v, device="cpu", values_are_ranks=False, bit_count=4), (k, v))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_signed_keys_bit_pattern_and_total_order(dtype):
    rng = np.random.default_rng(3)
    k = (rng.standard_normal(900) * 1000).astype(dtype)
    if dtype == np.float32:
        k[::37] = np.nan
        k[::41] = -np.inf
        k[::43] = -0.0
    v = rng.standard_normal(900).astype(np.float32)
    for kw in ({}, {"total_order": True}, {"total_order": True, "descending": True},
               {"total_order": True, "bit_count": 20}):
        assert _eq(trt.sort(k, v, device="cpu", **kw), golden_sort(k, v, **kw)), kw
    srt = trt.sort(k, device="cpu", total_order=True)
    assert trt.is_sorted(srt, total_order=True)


@pytest.mark.parametrize("vdtype", [np.int64, np.float64, np.uint64, np.int32])
def test_value_dtypes(vdtype):
    rng = np.random.default_rng(4)
    k = _u32(rng, 600, 25)
    v = rng.integers(0, 2**62, 600, dtype=np.uint64).view(np.int64).astype(vdtype)
    assert _eq(trt.sort(k, v, device="cpu"), golden_sort(k, v))
    assert _eq(trt.sort(k, v, device="cpu", count=300, bit_count=8),
               golden_sort(k, v, count=300, bit_count=8))


def test_split_path_matches_golden(monkeypatch):
    """Non-pow2 sizes with >= 33% pad waste: prefix + remainder + one merge
    (SPLIT_MIN_N lowered so small sizes take the path; 1324 recurses)."""
    monkeypatch.setattr(sort_mod, "SPLIT_MIN_N", 256)
    rng = np.random.default_rng(5)
    for n in (300, 1040, 1324):
        k = _u32(rng, n, max(2, n // 4))
        k[rng.integers(0, n, 20)] = 0xFFFFFFFF
        v = np.arange(n, dtype=np.uint32)
        for kw in ({}, {"values_are_ranks": True}, {"bit_count": 8},
                   {"count": 2 * n // 3}, {"descending": True}, {"check_order": True}):
            assert _eq(trt.sort(k, v, device="cpu", tile=64, **kw),
                       golden_sort(k, v, **_gold_kw(kw))), (n, kw)
        assert _eq(trt.sort(k, device="cpu"), golden_sort(k))


def test_output_does_not_depend_on_tile():
    rng = np.random.default_rng(6)
    k = _u32(rng, 3000, 100)
    v = np.arange(3000, dtype=np.uint32)
    outs = [trt.sort(k, v, device="cpu", tile=t) for t in (2, 64, None)]
    for o in outs[1:]:
        assert _eq(o, tuple(_np(x) for x in outs[0]))


def test_suffix_untouched_and_no_aliasing():
    k = torch.arange(100, 0, -1, dtype=torch.int32).view(torch.uint32)
    out = trt.sort(k, count=60)
    assert _eq(out, golden_sort(_np(k), count=60))
    out[0] = 7
    assert int(k[0]) == 100
    srt = trt.sort(k)
    same = trt.sort(srt, check_order=True)
    assert _eq(same, _np(srt)) and same.data_ptr() != srt.data_ptr()


def test_argsort_and_sort_packed():
    rng = np.random.default_rng(7)
    k = _u32(rng, 1200, 50)
    idx = trt.argsort(k, device="cpu")
    assert idx.dtype == torch.uint32
    assert np.array_equal(_np(idx), np.argsort(k, kind="stable").astype(np.uint32))
    packed = np.stack([k, np.arange(1200, dtype=np.uint32)], -1).reshape(20, 60, 2)
    out = trt.sort_packed(packed, device="cpu", count=1000)
    rk, rv = golden_sort(k, np.arange(1200, dtype=np.uint32), count=1000)
    assert out.shape == (20, 60, 2)
    assert np.array_equal(_np(out).reshape(-1, 2), np.stack([rk, rv], -1))


def test_kernel_classes():
    rng = np.random.default_rng(8)
    k = _u32(rng, 900, 30)
    v = np.arange(900, dtype=np.uint32)
    kern = trt.RadixSortBufferKernel(count=800, has_values=True, bit_count=8,
                                     values_are_ranks=True, device="cpu")
    assert kern.compile() is kern
    assert _eq(kern.dispatch(k, v), golden_sort(k, v, count=800, bit_count=8))
    with pytest.raises(ValueError):
        kern.dispatch(k)
    keys_only = trt.RadixSortKernel(count=900, descending=True, device="cpu").compile()
    assert _eq(keys_only.dispatch(k), golden_sort(k, descending=True))
    with pytest.raises(ValueError):
        keys_only.dispatch(k, v)
    packed = np.stack([k, v], -1)
    pk = trt.RadixSortTextureKernel(count=900, device="cpu")
    assert np.array_equal(_np(pk.dispatch(packed)), np.stack(golden_sort(k, v), -1))
    assert trt.RadixSortTextureKernel is trt.RadixSortPackedKernel
    with pytest.raises(ValueError):
        trt.RadixSortKernel(count=8, bit_count=7)
    with pytest.raises(NotImplementedError):
        trt.RadixSortKernel(count=8, key_dtype=torch.uint64)


def test_input_errors_match_jax_types():
    z = np.zeros(8, np.uint32)
    cases = [
        (TypeError, lambda: trt.sort(np.zeros(8, np.int8), device="cpu")),
        (ValueError, lambda: trt.sort(np.zeros((2, 4), np.uint32), device="cpu")),
        (ValueError, lambda: trt.sort(z, bit_count=7, device="cpu")),
        (ValueError, lambda: trt.sort(z, bit_count=36, device="cpu")),
        (ValueError, lambda: trt.sort(z, count=9, device="cpu")),
        (ValueError, lambda: trt.sort(z, np.zeros(4, np.uint32), device="cpu")),
        (ValueError, lambda: trt.sort(z, method="bogus", device="cpu")),
        (TypeError, lambda: trt.sort(z, np.zeros(8, np.int16), device="cpu")),
        (ValueError, lambda: trt.sort(z, np.zeros(8, np.int64), device="cpu",
                                      values_are_ranks=True)),
        (ValueError, lambda: trt.sort_packed(np.zeros((4, 3), np.uint32), device="cpu")),
        (NotImplementedError, lambda: trt.sort(z, method="radix", device="cpu")),
        (NotImplementedError, lambda: trt.sort(np.zeros(8, np.uint16), device="cpu")),
        (NotImplementedError, lambda: trt.sort(np.zeros(8, np.float64), device="cpu")),
        (NotImplementedError, lambda: trt.sort(z, device="cpu", mesh=object())),
    ]
    for exc, fn in cases:
        with pytest.raises(exc):
            fn()
    # the JAX package raises the same types for the shared cases
    for exc, fn in [
        (ValueError, lambda: jtrs.sort(jnp.zeros((2, 4), jnp.uint32))),
        (ValueError, lambda: jtrs.sort(jnp.zeros(8, jnp.uint32), bit_count=7)),
        (ValueError, lambda: jtrs.sort(jnp.zeros(8, jnp.uint32), count=9)),
        (ValueError, lambda: jtrs.sort(jnp.zeros(8, jnp.uint32), method="bogus")),
        (TypeError, lambda: jtrs.sort(jnp.zeros(8, jnp.int8))),
    ]:
        with pytest.raises(exc):
            fn()


def test_device_time_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        device_time(trt.sort, torch.zeros(8, dtype=torch.uint32))
