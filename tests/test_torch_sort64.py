"""Port parity of the 64-bit key path (`ops/sort64.py`; kernels K1, K3, K5,
K4 and K6 through their plain versions on the CPU): uint64/int64/float64
keys and 8-byte values, byte-exact (tolerance 0, integer work) against the
JAX package and its numpy golden.

JAX in 64-bit mode is slow to compile, so the JAX package's device code is
called three times in all: one bitonic key+value sort, the two-column
order check through its Pallas kernel (interpret mode, an inversion across
its 2,048-row block boundary) and the 64-bit key bijections. x64 mode is
on only around those calls. Everything else is held against the JAX
package's numpy golden (``torch_golden_ref``: its ``golden_sort``, and for
total order the stable order of its bijection mirror)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_radix_sort as jtrs
import tpu_radix_sort_torch as trt
from tpu_radix_sort.models import golden as jax_golden
from tpu_radix_sort.ops import checksort as jchecksort
from tpu_radix_sort.ops import common as jcommon
from tpu_radix_sort_torch.models.golden import golden_is_sorted
from tpu_radix_sort_torch.ops import bitonic, common, radix
from tpu_radix_sort_torch.ops import sort as sort_mod
from torch_golden_ref import golden_sort

GOLD_KW = ("count", "bit_count", "descending", "total_order")


@contextlib.contextmanager
def _x64():
    """JAX x64 mode around a block, restored after (no 32-bit test on the
    same worker inherits it, nor its compiled pipelines)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    jax.clear_caches()
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)
        jax.clear_caches()


def _u64_keys(rng, n, dup_hi=True):
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    if dup_hi:
        # duplicate hi words so the (hi, lo) lexicographic chain is decisive
        k[: n // 2] = (k[: n // 2] & np.uint64(0xFFFFFFFF)) | (
            np.uint64(0xABCD1234) << np.uint64(32))
    return k


def _eq(got, want):
    """Byte equality of a result (tensor or pair) with numpy arrays."""
    if isinstance(want, tuple):
        return len(got) == len(want) and all(_eq(g, w) for g, w in zip(got, want))
    g = got.numpy()
    return g.dtype == want.dtype and np.array_equal(g.view(np.uint8), want.view(np.uint8))


def _gold(kw):
    return {a: b for a, b in kw.items() if a in GOLD_KW}


def test_matches_jax_sort64_bitonic():
    rng = np.random.default_rng(0)
    n = 900
    k = _u64_keys(rng, n)
    k[100:200] = k[100]  # an all-equal run: stability from the tie column
    v = np.arange(n, dtype=np.uint32)
    with _x64():
        jk, jv = jtrs.sort(jnp.asarray(k), jnp.asarray(v), method="bitonic")
        jk, jv = np.asarray(jk), np.asarray(jv)
    assert jk.dtype == np.uint64
    for kw in ({}, {"values_are_ranks": True}, {"tile": 64}):
        assert _eq(trt.sort(k, v, device="cpu", **kw), (jk, jv)), kw
    gk, gv = golden_sort(k, v)
    assert np.array_equal(jk, gk) and np.array_equal(jv, gv)


def test_order_check_matches_jax_kernel_path():
    """K3's counterpart in the JAX package runs at >= PALLAS_MIN_ELEMENTS;
    the inversion sits across its block boundary (rows 2047 | 2048)."""
    block = jchecksort.BLOCK_ROWS * jchecksort.LANES
    m = block + 37_856  # a ragged last block, padded with sentinels there
    rng = np.random.default_rng(1)
    big = np.sort(rng.integers(0, 2**64, m, dtype=np.uint64))
    big[block] = big[block - 1] - np.uint64(1)
    big[-1] = 0  # and one at the very end
    with _x64():
        want = int(jtrs.disorder_count(jnp.asarray(big)))
    got = trt.disorder_count(big, device="cpu")
    assert got.dtype == torch.uint32 and got.dim() == 0
    assert int(got) == want == int(np.count_nonzero(big[:-1] > big[1:])) == 2
    assert not trt.is_sorted(big, device="cpu")
    big[block], big[-1] = big[block + 1], big[-2]
    assert trt.is_sorted(big, device="cpu")


@pytest.mark.parametrize("total", [False, True])
def test_key_bijections_match_jax(total):
    rng = np.random.default_rng(2)
    u = rng.integers(0, 2**64, 600, dtype=np.uint64)
    u[:5] = [0, 1, 2**63 - 1, 2**63, 2**64 - 1]
    u[5] = np.float64(np.nan).view(np.uint64)
    to = common.to_total_order_u64_cols if total else common.to_sortable_u64_cols
    back = common.from_total_order_u64_cols if total else common.from_sortable_u64_cols
    jto = jcommon.to_total_order_u64_cols if total else jcommon.to_sortable_u64_cols
    for dtype in (np.uint64, np.int64, np.float64):
        k = u.view(dtype)
        t = torch.from_numpy(k)
        hi, lo = to(t)
        with _x64():
            jhi, jlo = map(np.asarray, jto(jnp.asarray(k)))
        assert np.array_equal(hi.numpy().view(np.uint32), jhi)
        assert np.array_equal(lo.numpy().view(np.uint32), jlo)
        r = back(hi, lo, t.dtype)
        assert r.dtype == t.dtype and np.array_equal(r.numpy().view(np.uint64), u)


@pytest.mark.parametrize("method", ["bitonic", "radix", "xla"])
@pytest.mark.parametrize("kw", [
    {}, {"values_are_ranks": True}, {"bit_count": 4}, {"bit_count": 16},
    {"bit_count": 32}, {"bit_count": 40}, {"bit_count": 60},
    {"descending": True, "count": 600}, {"check_order": True},
])
def test_u64_options_match_golden(method, kw):
    rng = np.random.default_rng(3)
    n = 900
    k = _u64_keys(rng, n, dup_hi=kw.get("bit_count", 64) > 32)
    k[rng.integers(0, n, 40)] = 0xFFFFFFFFFFFFFFFF  # real all-ones beside the pads
    v = np.arange(n, dtype=np.uint32)
    assert _eq(trt.sort(k, v, device="cpu", method=method, tile=64, **kw),
               golden_sort(k, v, **_gold(kw)))
    if "values_are_ranks" not in kw:
        assert _eq(trt.sort(k, device="cpu", method=method, **kw),
                   golden_sort(k, **_gold(kw)))


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_i64_f64_bit_pattern_and_total_order(dtype):
    rng = np.random.default_rng(4)
    n = 500
    if dtype == np.int64:
        k = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    else:
        k = (rng.random(n) - 0.5) * 1e9
        k[::37] = np.nan
        k[::41] = -np.inf
        k[::43] = -0.0
    v = rng.standard_normal(n)
    for kw in ({}, {"total_order": True}, {"total_order": True, "descending": True},
               {"total_order": True, "bit_count": 40, "count": 333}):
        for method in ("bitonic", "radix"):
            assert _eq(trt.sort(k, v, device="cpu", method=method, **kw),
                       golden_sort(k, v, **kw)), (kw, method)
    finite = k[np.isfinite(k)] if dtype == np.float64 else k
    assert _eq(trt.sort(finite, device="cpu", total_order=True),
               np.sort(finite, kind="stable"))
    assert _eq(trt.sort(finite, device="cpu", total_order=True, descending=True),
               np.sort(finite, kind="stable")[::-1].copy())


@pytest.mark.parametrize("method", ["auto", "radix", "xla"])
def test_check_order_gates_every_engine(method, monkeypatch):
    """Sorted input takes the passthrough: a poisoned engine shows only when
    the gate lets the sort run. The radix engine is gated up front too."""
    rng = np.random.default_rng(5)
    k = _u64_keys(rng, 800)
    ks = golden_sort(k)
    v = rng.integers(0, 2**64, 800, dtype=np.uint64)
    assert _eq(trt.sort(k, device="cpu", method=method, check_order=True), ks)
    real = sort_mod._engine_sort

    def poisoned(key_cols, payloads, **kw):
        kc, ps = real(key_cols, payloads, **kw)
        return tuple(c ^ 0x5A5A5A5A for c in kc), ps

    monkeypatch.setattr(sort_mod, "_engine_sort", poisoned)
    passes = []
    monkeypatch.setattr(radix, "reorder_pass_plain",
                        lambda *a, _f=radix.reorder_pass_plain, **kw: passes.append(1) or _f(*a, **kw))
    assert _eq(trt.sort(ks, v, device="cpu", method=method, check_order=True), (ks, v))
    assert passes == []
    assert not _eq(trt.sort(k, device="cpu", method=method, check_order=True), ks)


def test_order_checks_and_their_key_views():
    rng = np.random.default_rng(6)
    n = 3000
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    ks = golden_sort(k)
    assert trt.is_sorted(ks, device="cpu") and not trt.is_sorted(k, device="cpu")
    assert int(trt.disorder_count(ks, device="cpu")) == 0
    assert int(trt.disorder_count(k, device="cpu")) == int(np.sum(k[:-1] > k[1:]))
    c = n // 2
    assert int(trt.disorder_count(k, device="cpu", count=c)) == int(
        np.sum(k[: c - 1] > k[1:c]))
    f = rng.standard_normal(n)
    i = rng.integers(-(2**62), 2**62, n).astype(np.int64)
    for x, kw in ((k, {"bit_count": 4}), (k, {"bit_count": 40, "descending": True}),
                  (f, {"total_order": True}), (i, {"total_order": True, "descending": True}),
                  (k, {"descending": True, "bit_count": 16})):
        for arr in (x, golden_sort(x, **kw)):
            want = golden_is_sorted(arr, **kw)
            assert want == jax_golden.golden_is_sorted(arr, **kw)
            assert trt.is_sorted(arr, device="cpu", **kw) == want, kw
            assert (int(trt.disorder_count(arr, device="cpu", **kw)) == 0) == want, kw
    # a raw bit-pattern view of totally-ordered negatives is unsorted
    assert not trt.is_sorted(golden_sort(f, total_order=True), device="cpu")


def test_split_path_matches_golden(monkeypatch):
    """Non-pow2 sizes with >= 33% pad waste: prefix + remainder + one merge
    (SPLIT_MIN_N lowered; 1324 recurses), and real all-ones u64 keys that
    must precede the sentinel pads."""
    monkeypatch.setattr(sort_mod, "SPLIT_MIN_N", 256)
    rng = np.random.default_rng(7)
    for n in (300, 1040, 1324):
        k = rng.integers(0, 2**64, n, dtype=np.uint64)
        k[: n // 3] = (k[: n // 3] & np.uint64(0xFF)) | (np.uint64(5) << np.uint64(32))
        v = np.arange(n, dtype=np.uint32)
        assert _eq(trt.sort(k, device="cpu", tile=64, method="bitonic"), golden_sort(k))
        for kw in ({}, {"values_are_ranks": True}):
            assert _eq(trt.sort(k, v, device="cpu", tile=64, method="bitonic", **kw),
                       golden_sort(k, v)), n
        c = 2 * n // 3
        assert _eq(trt.sort(k, device="cpu", count=c, bit_count=40, method="bitonic"),
                   golden_sort(k, count=c, bit_count=40))
    k = np.full(1040, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
    k[rng.integers(0, 1040, 200)] = rng.integers(0, 2**64, 200, dtype=np.uint64)
    v = np.arange(1040, dtype=np.uint32)
    assert _eq(trt.sort(k, v, device="cpu", method="bitonic"), golden_sort(k, v))


@pytest.mark.parametrize("vdtype", [np.uint64, np.int64, np.float64])
def test_wide_values_all_engines(vdtype):
    """8-byte values ride as (hi, lo) column pairs, on 32- and 64-bit keys."""
    rng = np.random.default_rng(8)
    n = 2048
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    k[: n // 4] = 0x1234
    k64 = rng.integers(0, 2**64, n, dtype=np.uint64)
    k64[: n // 3] = np.uint64(5) << np.uint64(32)
    if vdtype == np.float64:
        v = rng.standard_normal(n)
    else:
        v = rng.integers(0, 2**62, n, dtype=np.uint64).astype(vdtype)
    for m in ("bitonic", "radix", "xla"):
        assert _eq(trt.sort(k, v, device="cpu", method=m), golden_sort(k, v)), m
        assert _eq(trt.sort(k64, v, device="cpu", method=m), golden_sort(k64, v)), m
    kw = dict(count=1500, bit_count=12, descending=True)
    assert _eq(trt.sort(k, v, device="cpu", **kw), golden_sort(k, v, **kw))
    ks = golden_sort(k)
    assert _eq(trt.sort(ks, v, device="cpu", check_order=True), (ks, v))


def test_widest_paths_carry_seven_and_six_columns(monkeypatch):
    """bit_count in 36..60 with 8-byte values that are not ranks: the
    network carries (hi, lo, tie, u_hi, u_lo, v_hi, v_lo), n_keys 3, and
    the radix engine sorts lo carrying 5 columns."""
    seen = {"bitonic": set(), "radix": set()}
    real_sort, real_pass = bitonic.sort_padded_cols, radix.reorder_pass

    def sort_cols(x, *, n_keys, tile=None):
        seen["bitonic"].add((x.shape[0], n_keys))
        return real_sort(x, n_keys=n_keys, tile=tile)

    def reorder(x, offs, **kw):
        seen["radix"].add(x.shape[0])
        return real_pass(x, offs, **kw)

    monkeypatch.setattr(bitonic, "sort_padded_cols", sort_cols)
    monkeypatch.setattr(radix, "reorder_pass", reorder)
    rng = np.random.default_rng(9)
    n = 1000
    k = _u64_keys(rng, n)
    v = rng.integers(0, 2**64, n, dtype=np.uint64)
    for m in ("bitonic", "radix"):
        assert _eq(trt.sort(k, v, device="cpu", method=m, bit_count=40),
                   golden_sort(k, v, bit_count=40))
    assert seen == {"bitonic": {(7, 3)}, "radix": {6}}
    iota = np.arange(n, dtype=np.uint32)
    assert _eq(trt.sort(k, iota, device="cpu", values_are_ranks=True), golden_sort(k, iota))
    assert _eq(trt.argsort(k, device="cpu"), np.argsort(k, kind="stable").astype(np.uint32))
    assert (3, 3) in seen["bitonic"]  # (hi, lo, rank)


def test_kernel_class_and_validation():
    rng = np.random.default_rng(10)
    n = 800
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    v = np.arange(n, dtype=np.uint32)
    kern = trt.RadixSortKernel(count=n, has_values=True, key_dtype=torch.uint64,
                               device="cpu").compile()
    assert kern.bit_count == 64
    assert _eq(kern.dispatch(k, v), golden_sort(k, v))
    k16 = trt.RadixSortKernel(count=n, key_dtype=torch.uint64, bit_count=16,
                              method="radix", device="cpu")
    assert _eq(k16.dispatch(k), golden_sort(k, bit_count=16))
    for exc, fn in [
        (ValueError, lambda: trt.RadixSortKernel(count=n, key_dtype=torch.uint64, bit_count=68)),
        (ValueError, lambda: trt.RadixSortKernel(count=n, key_dtype=torch.uint32, bit_count=64)),
        (ValueError, lambda: trt.sort(k, bit_count=68, device="cpu")),
        (ValueError, lambda: trt.sort(k, bit_count=6, device="cpu")),
        (TypeError, lambda: trt.sort(k, np.zeros(n, np.float16), device="cpu")),
        (ValueError, lambda: trt.sort(k, count=n + 1, device="cpu")),
        (ValueError, lambda: trt.sort(k, k, values_are_ranks=True, device="cpu")),
    ]:
        with pytest.raises(exc):
            fn()
