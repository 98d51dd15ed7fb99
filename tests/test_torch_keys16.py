"""Port parity of 16-bit keys (uint16 / int16 / float16 / bfloat16): the
u16 bit pattern widened into a u32 lane, `bit_count` up to 16, the radix
engine at 2 passes of 8 bits, bfloat16 across the numpy boundary as its bits.
Byte-exact (tolerance 0) against the JAX package and the numpy golden.

One JAX sort (bfloat16 key+value through the bitonic engine, total order,
descending, a sub-count) and the 16-bit key bijections are held against the
JAX package; the rest against its numpy golden (``torch_golden_ref``).
bfloat16 keys are built from a numpy u16 pattern:
``.view(ml_dtypes.bfloat16)`` for JAX and its golden,
``torch.from_numpy(u16.view(np.int16)).view(torch.bfloat16)`` for the port,
and the u16 pattern itself with ``bf16_bits=True`` for the port's golden."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_radix_sort as jtrs
import tpu_radix_sort_torch as trt
from tpu_radix_sort.ops import common as jcommon
from tpu_radix_sort_torch.models import golden as port_golden
from tpu_radix_sort_torch.ops import bitonic, common, radix
from tpu_radix_sort_torch.utils import interop
from torch_golden_ref import golden_sort

DTYPES = (np.uint16, np.int16, np.float16, ml_dtypes.bfloat16)


def _keys(rng, n, dtype):
    if dtype == np.uint16:
        k = rng.integers(0, 2**16, n).astype(np.uint16)
    elif dtype == np.int16:
        k = rng.integers(-(2**15), 2**15, n).astype(np.int16)
    else:
        k = rng.standard_normal(n).astype(dtype)
        k[::53] = np.nan
        k[::59] = -np.inf
        k[::61] = -0.0
    k[: n // 8] = k[0]  # equal-key runs: stability must hold
    return k


def _port(k):
    """numpy 16-bit keys -> the port's tensor (bfloat16 from its bits)."""
    if k.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(k.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(k)


def _bits(x):
    """u16 bit patterns of a tensor or a numpy array."""
    if isinstance(x, torch.Tensor):
        return interop.to_numpy(x).view(np.uint16)
    return np.asarray(x).view(np.uint16)


def test_matches_jax_bfloat16_sort():
    rng = np.random.default_rng(0)
    n = 1000
    k = _keys(rng, n, ml_dtypes.bfloat16)
    v = np.arange(n, dtype=np.uint32)
    kw = dict(total_order=True, descending=True, count=777)
    jk, jv = jtrs.sort(jnp.asarray(k), jnp.asarray(v), method="bitonic", **kw)
    ok, ov = trt.sort(_port(k), torch.from_numpy(v), **kw)
    assert ok.dtype == torch.bfloat16
    assert np.array_equal(_bits(ok), _bits(jk)) and np.array_equal(ov.numpy(), np.asarray(jv))
    gk, gv = golden_sort(k, v, **kw)
    assert np.array_equal(_bits(ok), _bits(gk)) and np.array_equal(ov.numpy(), gv)
    pk, pv = port_golden.golden_sort(_bits(k), v, bf16_bits=True, **kw)
    assert np.array_equal(pk, _bits(gk)) and np.array_equal(pv, gv)


@pytest.mark.parametrize("total", [False, True])
def test_key_bijections_match_jax(total):
    u = np.arange(0, 2**16, 7, dtype=np.uint16)
    to = common.to_total_order_u32 if total else common.to_sortable_u32
    back = common.from_total_order_u32 if total else common.from_sortable_u32
    jto = jcommon.to_total_order_u32 if total else jcommon.to_sortable_u32
    for dtype in DTYPES:
        k = u.view(dtype)
        t = _port(k)
        got = to(t)
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(jto(jnp.asarray(k))))
        r = back(got, t.dtype)
        assert r.dtype == t.dtype and np.array_equal(_bits(r), u)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["bitonic", "radix", "xla"])
def test_all_engines_match_golden(dtype, method):
    rng = np.random.default_rng(1)
    for n in (100, 3000):
        k = _keys(rng, n, dtype)
        assert np.array_equal(_bits(trt.sort(_port(k), method=method)), _bits(golden_sort(k)))
        got = trt.sort(_port(k), method=method, total_order=True)
        assert np.array_equal(_bits(got), _bits(golden_sort(k, total_order=True)))
        assert trt.is_sorted(got, total_order=True)
        assert port_golden.golden_is_sorted(interop.to_numpy(got), total_order=True,
                                            bf16_bits=dtype == ml_dtypes.bfloat16)


def test_total_order_is_numeric_order():
    rng = np.random.default_rng(2)
    for dtype in DTYPES:
        k = _keys(rng, 2048, dtype)
        if k.dtype.kind != "i" and k.dtype.kind != "u":
            k = k[np.isfinite(k.astype(np.float32)) & (k != 0)]
        assert np.array_equal(_bits(trt.sort(_port(k), total_order=True)),
                              _bits(np.sort(k, kind="stable")))


def test_option_surface_and_checks():
    rng = np.random.default_rng(3)
    n = 3000
    k = _keys(rng, n, np.uint16)
    v = np.arange(n, dtype=np.uint32)
    kw = dict(bit_count=8, descending=True, count=2222)
    for method in ("bitonic", "radix"):
        ok, ov = trt.sort(k, v, device="cpu", method=method, **kw)
        gk, gv = golden_sort(k, v, **kw)
        assert np.array_equal(ok.numpy(), gk) and np.array_equal(ov.numpy(), gv)
    sd = trt.sort(k, device="cpu", descending=True)
    assert trt.is_sorted(sd, descending=True) and not trt.is_sorted(sd)
    assert int(trt.disorder_count(k, device="cpu")) == int(np.sum(k[:-1] > k[1:]))
    a = trt.argsort(k, device="cpu")
    assert np.array_equal(a.numpy(), np.argsort(k, kind="stable").astype(np.uint32))
    ks = golden_sort(k)
    assert np.array_equal(trt.sort(ks, device="cpu", check_order=True).numpy(), ks)
    v64 = rng.integers(0, 2**64, n, dtype=np.uint64)  # 8-byte values compose
    ok, ov = trt.sort(k, v64, device="cpu")
    gk, gv = golden_sort(k, v64)
    assert np.array_equal(ok.numpy(), gk) and np.array_equal(ov.numpy(), gv)
    for fn in (lambda: trt.sort(k, bit_count=20, device="cpu"),
               lambda: trt.is_sorted(k, bit_count=32, device="cpu")):
        with pytest.raises(ValueError):
            fn()


def test_native_width_rule(monkeypatch):
    """A 16-bit key at bit_count 16 is the whole key: the network carries no
    full-key column (as in the JAX package), and the radix engine runs 2
    passes of 8 bits over the default 16 bits."""
    seen, passes = [], []
    real_sort, real_pass = bitonic.sort_padded_cols, radix.reorder_pass
    monkeypatch.setattr(bitonic, "sort_padded_cols",
                        lambda x, **kw: seen.append(x.shape[0]) or real_sort(x, **kw))
    monkeypatch.setattr(radix, "reorder_pass",
                        lambda x, o, **kw: passes.append(x.shape[0]) or real_pass(x, o, **kw))
    rng = np.random.default_rng(4)
    k = _keys(rng, 1000, ml_dtypes.bfloat16)
    trt.sort(_port(k))
    trt.sort(_port(k), bit_count=12)
    assert seen == [1, 3]  # keys-only; masked: (key, tie, full key)
    trt.sort(_port(k), method="radix")
    assert passes == [1] * 2


def test_interop_and_golden_carry_bfloat16_as_bits():
    u = np.array([0x3F80, 0xBF80, 0x7FC0, 0x0000, 0x8000], np.uint16)
    b = u.view(ml_dtypes.bfloat16)
    t = interop.from_numpy(b, "cpu")
    assert t.dtype == torch.bfloat16 and t.tolist()[:2] == [1.0, -1.0]
    back = interop.to_numpy(t)
    assert back.dtype == np.uint16 and np.array_equal(back, u)
    want = golden_sort(b, total_order=True).view(np.uint16)
    assert np.array_equal(port_golden.golden_sort(u, total_order=True, bf16_bits=True), want)
    assert not np.array_equal(port_golden.golden_sort(u, total_order=True), want)


def test_kernel_class_quirk():
    """As in the JAX class, a 16-bit key_dtype defaults bit_count to 32,
    which the sort refuses at dispatch; an explicit 16 works."""
    k = np.arange(64, dtype=np.uint16)[::-1].copy()
    kern = trt.RadixSortKernel(count=64, key_dtype=torch.uint16, device="cpu")
    assert kern.bit_count == 32
    with pytest.raises(ValueError):
        kern.dispatch(k)
    with pytest.raises(ValueError):
        jtrs.RadixSortKernel(count=64, key_dtype=jnp.uint16).dispatch(jnp.asarray(k))
    kern16 = trt.RadixSortKernel(count=64, key_dtype=torch.uint16, bit_count=16,
                                 device="cpu")
    assert np.array_equal(kern16.dispatch(k).numpy(), np.sort(k))
