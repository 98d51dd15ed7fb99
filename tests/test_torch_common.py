"""Port parity: key bijections, value columns, golden, interop, dispatch,
and the port's guards (no JAX import, CPU runs launch no kernel, no silent
CPU fallback). Byte-exact (tolerance 0) against the JAX package."""
import ast
import pathlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_radix_sort_torch as trt
from tpu_radix_sort.models import golden as jax_golden
from tpu_radix_sort.ops import common as jcommon
from tpu_radix_sort_torch import _build
from tpu_radix_sort_torch.models import golden
from tpu_radix_sort_torch.ops import common
from tpu_radix_sort_torch.utils import dispatch, interop
import torch_golden_ref as golden_ref

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _keys(dtype, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    u[:6] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x7FC00000]  # incl. NaN bits
    return u.view(dtype)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
@pytest.mark.parametrize("total", [False, True])
def test_key_bijections_match_jax(dtype, total):
    k = _keys(dtype)
    jt = jcommon.to_total_order_u32 if total else jcommon.to_sortable_u32
    jf = jcommon.from_total_order_u32 if total else jcommon.from_sortable_u32
    tt = common.to_total_order_u32 if total else common.to_sortable_u32
    tf = common.from_total_order_u32 if total else common.from_sortable_u32
    want = np.asarray(jt(jnp.asarray(k)))
    got = tt(interop.from_numpy(k, CPU))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    back = tf(got, interop.from_numpy(k, CPU).dtype)
    want_back = np.asarray(jf(jnp.asarray(want), jnp.dtype(dtype)))
    assert np.array_equal(interop.to_numpy(back).view(np.uint32), want_back.view(np.uint32))
    assert np.array_equal(interop.to_numpy(back).view(np.uint32), k.view(np.uint32))


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.uint64, np.int64, np.float64])
def test_value_columns_round_trip(dtype):
    rng = np.random.default_rng(1)
    v = rng.integers(0, 2**63, 500, dtype=np.uint64)
    v = (v.astype(np.uint32) if np.dtype(dtype).itemsize == 4 else v).view(dtype)
    t = interop.from_numpy(v, CPU)
    cols = common.values_to_u32_cols(t)
    if v.dtype.itemsize == 4:
        want = (v.view(np.uint32),)
    else:  # (hi, lo) u32 bit-pattern pair, as the JAX package splits u64
        u = v.view(np.uint64)
        want = ((u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32))
    assert len(cols) == len(want)
    for c, w in zip(cols, want):
        assert np.array_equal(c.numpy().view(np.uint32), w)
    back = common.values_from_u32_cols(cols, t.dtype)
    assert back.dtype == t.dtype
    assert np.array_equal(back.numpy().view(np.uint8), v.view(np.uint8))


def test_small_helpers_match_jax():
    for b in range(4, 33, 4):
        assert common.bit_mask(b) == int(jcommon.bit_mask(b))
    for n in (0, 1, 2, 3, 127, 128, 129, 1 << 20):
        assert common.next_pow2(n) == jcommon.next_pow2(n)
        assert common.cdiv(n, 7) == jcommon.cdiv(n, 7)
        assert common.round_up(n, 128) == jcommon.round_up(n, 128)
    x = torch.tensor([1, 2], dtype=torch.int32)
    p = common.pad_to(x, 5, common.SENTINEL_U32)
    assert p.view(torch.uint32).tolist() == [1, 2, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF]
    assert common.pad_to(x, 2, 0) is x


def test_validators():
    for bad in (0, 3, 7, 36, 64):
        with pytest.raises(ValueError):
            common.validate_bit_count_for(torch.uint32, bad)
        with pytest.raises(ValueError):
            common.validate_bit_count(bad)
    common.validate_bit_count_for(torch.float32, 12)
    # the range follows the key's width: [4, 16] for 16-bit keys, [4, 64]
    # for 64-bit keys
    common.validate_bit_count_for(torch.uint16, 16)
    common.validate_bit_count_for(torch.float64, 64)
    for dtype, bad in ((torch.bfloat16, 20), (torch.uint64, 68), (torch.int64, 6)):
        with pytest.raises(ValueError):
            common.validate_bit_count_for(dtype, bad)
    with pytest.raises(TypeError):
        common.check_key_dtype(torch.int8)
    with pytest.raises(TypeError):
        common.validate_value_dtype(torch.zeros(2, dtype=torch.int16))
    common.validate_value_dtype(torch.zeros(2, dtype=torch.float64))


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32,
                                   np.uint16, np.int16, np.float16, "bfloat16",
                                   np.uint64, np.int64, np.float64])
def test_golden_matches_jax_golden(dtype):
    """The port's golden against the JAX package's, at every key width;
    bfloat16 reaches the port's golden as its u16 patterns with
    `bf16_bits`, and the JAX golden as an ml_dtypes array."""
    rng = np.random.default_rng(2)
    bf16 = dtype == "bfloat16"
    width = 16 if bf16 else 8 * np.dtype(dtype).itemsize
    ut = {16: np.uint16, 32: np.uint32, 64: np.uint64}[width]
    # few distinct low bits (ties under every mask), a fixed exponent bit,
    # and the sign bit on every 7th key (negatives under total order)
    u = rng.integers(0, 300, 3000, dtype=np.uint64).astype(ut) | ut(1 << (width - 2))
    u[::7] |= ut(1 << (width - 1))
    k = u if bf16 else u.view(dtype)
    jk = u.view(ml_dtypes.bfloat16) if bf16 else k
    flag = {"bf16_bits": True} if bf16 else {}
    v = np.arange(3000, dtype=np.uint32)
    kws = [{}, {"count": 1700}, {"bit_count": 8}, {"descending": True},
           {"bit_count": 12, "descending": True, "count": 2000}]
    if width == 64:
        kws += [{"bit_count": 40}, {"bit_count": 60, "descending": True, "count": 2500}]
    for kw in kws:
        got = golden.golden_sort(k, v, **kw, **flag)
        want = jax_golden.golden_sort(jk, v, **kw)
        assert all(np.array_equal(a.view(np.uint8), b.view(np.uint8))
                   for a, b in zip(got, want)), kw
        s, js = got[0], want[0]
        for ckw in ({}, {"total_order": True}, {"descending": True}):
            ckw = {**ckw, **{a: b for a, b in kw.items() if a != "descending"}}
            assert (golden.golden_is_sorted(s, **ckw, **flag)
                    == jax_golden.golden_is_sorted(js, **ckw)), ckw
        # total_order: the JAX golden has no such sort; its bijection
        # mirror, masked and flipped by its own golden_sort, gives the order
        want = golden_ref.golden_sort(jk, v, total_order=True, **kw)
        got = golden.golden_sort(k, v, total_order=True, **kw, **flag)
        assert all(np.array_equal(a.view(np.uint8), b.view(np.uint8))
                   for a, b in zip(got, want)), ("total_order", kw)


def test_interop_round_trip_and_device_policy():
    for arr in (_keys(np.uint32), _keys(np.float32), np.arange(5, dtype=np.int64)):
        t = interop.from_numpy(arr, "cpu")
        assert t.device == CPU and str(t.dtype).endswith(arr.dtype.name)
        assert np.array_equal(interop.to_numpy(t).view(np.uint8), arr.view(np.uint8))
    t = torch.zeros(3, dtype=torch.int32)
    assert interop.as_tensor(t) is t
    assert interop.as_tensor([1, 2], device="cpu").tolist() == [1, 2]


def test_choose_tile_fits_shared_memory():
    for n_arr in range(1, 8):
        t = dispatch.choose_tile(1 << 26, n_arr)
        assert t & (t - 1) == 0
        assert n_arr * t * 4 <= dispatch.SMEM_BUDGET_BYTES < n_arr * 2 * t * 4
    assert dispatch.choose_tile(128, 1) == 128
    assert dispatch.choose_tile(1 << 26, 2) == 16384


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "tpu_radix_sort_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpu_radix_sort"), (f, mod)


def test_cpu_runs_launch_no_kernel_and_numpy_needs_a_device(monkeypatch):
    _build.reset_launches()
    k = _keys(np.uint32, n=3000)
    v = np.arange(3000, dtype=np.uint32)
    ok, ov = trt.sort(k, v, device="cpu", values_are_ranks=True, check_order=True)
    assert np.array_equal(ok.numpy(), golden.golden_sort(k))
    rk = trt.sort(k, device="cpu", method="radix", check_order=True)
    assert np.array_equal(rk.numpy(), golden.golden_sort(k))
    assert not trt.is_sorted(k, device="cpu")
    int(trt.disorder_count(torch.from_numpy(k)))
    k64 = k.astype(np.uint64) << np.uint64(20)
    assert np.array_equal(trt.sort(k64, device="cpu", check_order=True).numpy(),
                          golden.golden_sort(k64))
    assert not trt.is_sorted(k64, device="cpu")
    assert np.array_equal(trt.prefix_sum(v, device="cpu").numpy(),
                          golden.golden_prefix_sum(v))
    assert _build.launch_counts() == {
        "bitonic_tile_kernel": 0, "bitonic_global_stage_kernel": 0,
        "disorder_kernel": 0, "disorder_cols_kernel": 0, "scan_kernel": 0,
        "digit_histogram_kernel": 0, "reorder_kernel": 0, "explore_ce_kernel": 0,
        "blocksort_ce_kernel": 0, "blocksort_stages_kernel": 0,
        "blocksort_stages_split_kernel": 0, "keys16_stage_kernel": 0,
        "blocksum_kernel": 0, "addback_kernel": 0, "grid_copy_kernel": 0,
        "chained_scan_kernel": 0, "cummax_kernel": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: trt.sort(k), lambda: trt.argsort(k),
               lambda: trt.sort(k, method="radix"),
               lambda: trt.is_sorted(k), lambda: trt.disorder_count(k),
               lambda: trt.prefix_sum(v),
               lambda: trt.sort_packed(np.zeros((4, 2), np.uint32)),
               lambda: trt.RadixSortKernel(count=8).compile(),
               lambda: trt.PrefixSumKernel(count=8).compile()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
