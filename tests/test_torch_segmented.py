"""Port parity of the segmented sorts (`sort_segments`, `argsort_segments`;
``ops/segmented.py``: segment ids and starts through kernel K4's plain
version, the composite (segment, key) network through K1's), byte-exact
(tolerance 0, integer work) against the JAX package and its numpy golden.

The JAX package is called three times, in interpret mode as its own tests
run it: a u32 key+value sort with empty segments at the start, in the
middle and at the end and a duplicate-heavy segment; the argsort of the
same keys; and a uint64 sort with `bit_count=40` and uint64 values, whose
network carries 8 columns and compares 4 key words (segment, hi, lo, tie),
in JAX's 64-bit mode for that call only. Everything else is held against a
per-segment oracle, the JAX package's numpy golden (``torch_golden_ref``)
applied to each segment."""
import contextlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_radix_sort as jtrs
import tpu_radix_sort_torch as trt
from tpu_radix_sort_torch.ops import segmented
from torch_golden_ref import golden_sort

# empty segments: two at the start, two in the middle, two at the end
OFFS = np.array([0, 0, 0, 7, 60, 60, 60, 100, 133, 200, 250, 250, 250], dtype=np.int32)
N = 250


@contextlib.contextmanager
def _x64():
    """JAX x64 mode around a block, restored after."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    jax.clear_caches()
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)
        jax.clear_caches()


def _eq(got, want):
    """Byte equality of a result (tensor, array or pair) with numpy arrays."""
    if isinstance(want, tuple):
        return len(got) == len(want) and all(_eq(g, w) for g, w in zip(got, want))
    if isinstance(got, torch.Tensor):
        got = (got.view(torch.int16).numpy() if got.dtype == torch.bfloat16
               else got.numpy())
    g, w = (a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a for a in (got, want))
    return g.shape == w.shape and np.array_equal(g.view(np.uint8), w.view(np.uint8))


def _segs_golden(k, offs, v=None, **kw):
    """The golden sort of each segment (keys, or (keys, values))."""
    k, v = k.copy(), None if v is None else v.copy()
    for a, b in zip(offs[:-1], offs[1:]):
        if b > a:
            out = golden_sort(k[a:b], None if v is None else v[a:b], **kw)
            if v is None:
                k[a:b] = out
            else:
                k[a:b], v[a:b] = out
    return k if v is None else (k, v)


def _golden_ranks(k, offs, **kw):
    """Per-segment stable ranks from the golden: the sorted positions' indices."""
    _, order = _segs_golden(k, offs, np.arange(k.shape[0], dtype=np.uint32), **kw)
    starts = np.repeat(offs[:-1], np.diff(offs)).astype(np.uint32)
    return order - starts


def _u32_keys(seed):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    k[100:133] %= 5  # a duplicate-heavy segment: stability
    k[7:20] = 0xFFFFFFFF  # real max keys beside the sentinel pads
    return k


def test_matches_jax_key_value_empty_segments():
    k = _u32_keys(0)
    v = np.random.default_rng(1).integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    want = tuple(np.asarray(a) for a in jtrs.sort_segments(
        jnp.asarray(k), jnp.asarray(OFFS), jnp.asarray(v)))
    assert _eq(want, _segs_golden(k, OFFS, v))
    for kw in ({}, {"tile": 64}, {"method": "xla"}):
        assert _eq(trt.sort_segments(k, OFFS, v, device="cpu", **kw), want), kw
    # offsets as a tensor of another integer type, or a list
    assert _eq(trt.sort_segments(torch.from_numpy(k), torch.from_numpy(OFFS.astype(np.int64)),
                                 torch.from_numpy(v)), want)
    assert _eq(trt.sort_segments(k, OFFS.tolist(), v, device="cpu"), want)


def test_matches_jax_argsort_empty_segments():
    k = _u32_keys(2)
    want = np.asarray(jtrs.argsort_segments(jnp.asarray(k), jnp.asarray(OFFS)))
    assert want.dtype == np.uint32 and _eq(want, _golden_ranks(k, OFFS))
    for kw in ({}, {"method": "xla"}):
        got = trt.argsort_segments(k, OFFS, device="cpu", **kw)
        assert got.dtype == torch.uint32 and _eq(got, want), kw


def test_matches_jax_u64_bit_count_40_u64_values():
    """The 8-column, 4-key-word network: (segment, hi, lo, tie), the full
    key's hi and lo, the value's hi and lo."""
    rng = np.random.default_rng(3)
    k = rng.integers(0, 2**64, N, dtype=np.uint64)
    k[60:100] = (k[60:100] & np.uint64(0xFF)) | (np.uint64(0xABCD) << np.uint64(32))
    v = rng.integers(0, 2**64, N, dtype=np.uint64)
    with _x64():
        want = tuple(np.asarray(a) for a in jtrs.sort_segments(
            jnp.asarray(k), jnp.asarray(OFFS), jnp.asarray(v), bit_count=40))
    assert want[0].dtype == np.uint64 and _eq(want, _segs_golden(k, OFFS, v, bit_count=40))
    for kw in ({}, {"tile": 128}, {"method": "xla"}):
        assert _eq(trt.sort_segments(k, OFFS, v, bit_count=40, device="cpu", **kw), want), kw


@pytest.mark.parametrize("case", [
    dict(dtype=np.uint32, kw=dict(bit_count=12)),  # packed: 4 + 12 bits
    dict(dtype=np.uint32, kw=dict(bit_count=12, descending=True), values=np.uint32),
    dict(dtype=np.uint32, kw=dict()),  # the id a column of its own
    dict(dtype=np.uint16, kw=dict()),  # packed, unmasked: key bits unpacked after
    dict(dtype=np.uint16, kw=dict(descending=True), values=np.int64),
    dict(dtype=np.float32, kw=dict(total_order=True), values="ranks"),
    dict(dtype=ml_dtypes.bfloat16, kw=dict(total_order=True, descending=True)),
    dict(dtype=np.int64, kw=dict(total_order=True), values=np.uint32),
    dict(dtype=np.uint64, kw=dict(bit_count=28)),  # (segment, lo)
], ids=lambda c: "-".join([np.dtype(c["dtype"]).name, *c["kw"],
                           str(c.get("values", "keys-only")).split(".")[-1].strip("'>")]))
def test_options_and_dtypes_match_golden(case):
    rng = np.random.default_rng(4)
    bits = 8 * np.dtype(case["dtype"]).itemsize
    raw = rng.integers(0, 2**bits, N, dtype=np.uint64)
    raw[100:200] %= 9  # duplicate keys: stability
    k = raw.astype(f"u{bits // 8}").view(case["dtype"])
    kw = dict(case["kw"])
    vals = case.get("values")
    if vals == "ranks":
        v = (np.arange(N) - np.repeat(OFFS[:-1], np.diff(OFFS))).astype(np.uint32)
        kw["values_are_ranks"] = True
    elif vals is not None:
        v = rng.integers(0, 2**31, N, dtype=np.int64).astype(vals)
    else:
        v = None
    gkw = {a: b for a, b in kw.items() if a != "values_are_ranks"}
    want = _segs_golden(k, OFFS, v, **gkw)
    pk = (torch.from_numpy(k.view(np.int16)).view(torch.bfloat16)
          if k.dtype == ml_dtypes.bfloat16 else torch.from_numpy(k))
    args = (pk, OFFS) if v is None else (pk, OFFS, torch.from_numpy(v))
    for method in ("bitonic", "xla"):
        assert _eq(trt.sort_segments(*args, method=method, **kw), want), method
    if v is None:
        ranks = trt.argsort_segments(pk, OFFS, **gkw)
        assert _eq(ranks, _golden_ranks(k, OFFS, **gkw))


def test_segment_ids_and_starts():
    n = 10
    for offs in ([0, 0, 0, 3, 3, 7, 10, 10], [0, 10], [0, 5, 10, 10, 10]):
        o = torch.tensor(offs, dtype=torch.int64)
        seg, starts = segmented.segment_ids_and_starts(o, n, need_starts=True)
        pos = np.arange(n)
        want_seg = np.searchsorted(np.array(offs[1:-1]), pos, side="right")
        want_start = np.array(offs)[np.searchsorted(np.array(offs), pos, side="right") - 1]
        assert np.array_equal(seg.numpy(), want_seg), offs
        assert np.array_equal(starts.numpy(), want_start), offs


def test_short_inputs():
    k = np.array([5], dtype=np.uint32)
    assert _eq(trt.sort_segments(k, [0, 1], device="cpu"), k)
    assert _eq(trt.argsort_segments(k, [0, 1], device="cpu"), np.zeros(1, np.uint32))
    e = np.zeros(0, dtype=np.uint32)
    assert _eq(trt.sort_segments(e, [0, 0], e, device="cpu"), (e, e))


def test_validation_matches_jax():
    k = torch.zeros(16, dtype=torch.uint32)
    with pytest.raises(ValueError):
        trt.sort_segments(torch.zeros((2, 8), dtype=torch.uint32), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        trt.sort_segments(k, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError):
        trt.sort_segments(k, torch.zeros(3, dtype=torch.float32))
    with pytest.raises(ValueError):
        trt.sort_segments(k, torch.tensor([0, 16]), method="radix")
    with pytest.raises(ValueError):
        trt.argsort_segments(k, torch.tensor([0, 16]), method="radix")
    with pytest.raises(TypeError):
        trt.sort_segments(torch.zeros(16, dtype=torch.uint8), torch.tensor([0, 16]))
    with pytest.raises(ValueError):
        trt.sort_segments(k, torch.tensor([0, 16]), torch.zeros(8, dtype=torch.uint32))
    with pytest.raises(TypeError):
        trt.sort_segments(k, torch.tensor([0, 16]), mesh=object())
    with pytest.raises(TypeError):
        trt.argsort_segments(k, torch.tensor([0, 16]), mesh=object())
