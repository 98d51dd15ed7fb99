"""The engine that ``method='auto'`` resolves to (``ops/sort.py``
``_resolve_method``): the bitonic network below ``AUTO_RADIX_MIN_N`` keys of
the key's width, the radix engine from it on, and an explicit `tile` that only the other engine
takes. With the threshold lowered, the radix route of 'auto' gives the
golden's bytes and those of ``method='bitonic'``."""
import ml_dtypes
import numpy as np
import pytest
import torch

import tpu_radix_sort_torch as trt
from tpu_radix_sort_torch.ops import radix
from tpu_radix_sort_torch.ops import sort as sort_mod
from torch_golden_ref import golden_sort


@pytest.mark.parametrize("check_order", [False, True])
@pytest.mark.parametrize("key_bits", [16, 32, 64])
def test_resolve_rule(monkeypatch, key_bits, check_order):
    """The rule per key width, through ``sort`` (so `check_order` reaches
    it) and directly; `check_order` does not move the threshold."""
    t = sort_mod.AUTO_RADIX_MIN_N[key_bits]

    def auto(count, tile=None):
        return sort_mod._resolve_method("auto", count=count, key_bits=key_bits, tile=tile)

    assert (auto(t - 1), auto(t), auto(t + 1), auto(4 * t)) == (
        "bitonic", "radix", "radix", "radix")
    # a tile both engines take leaves the rule as it is
    assert (auto(t - 1, tile=64), auto(t, tile=64)) == ("bitonic", "radix")
    # radix takes no tile under 32, the network none over 2^15
    assert auto(t, tile=16) == "bitonic"
    assert auto(t - 1, tile=1 << 16) == "radix"
    # a tile neither takes stays with the rule, whose engine refuses it
    assert (auto(t - 1, tile=3), auto(t, tile=3)) == ("bitonic", "radix")
    for m in ("bitonic", "radix", "xla"):
        assert sort_mod._resolve_method(m, count=t, key_bits=key_bits, tile=16) == m
    with pytest.raises(ValueError, match="method must be one of"):
        sort_mod._resolve_method("bogus", count=t, key_bits=key_bits)
    # through sort: 300 keys with the threshold at 256 take radix, 255 the network
    monkeypatch.setitem(sort_mod.AUTO_RADIX_MIN_N, key_bits, 256)
    seen = []
    real = sort_mod._resolve_method

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(sort_mod, "_resolve_method", spy)
    dtype = {16: np.uint16, 32: np.uint32, 64: np.uint64}[key_bits]
    k = np.random.default_rng(key_bits).integers(0, np.iinfo(dtype).max, 300, dtype=dtype)
    for count in (300, 255):
        out = trt.sort(k, device="cpu", count=count, check_order=check_order)
        assert np.array_equal(out.numpy(), golden_sort(k, count=count)), count
    assert seen == ["radix", "bitonic"]


def test_thresholds_as_measured():
    """The thresholds of the H100 sweep (PERF.md), the later of every
    payload, check_order and timing: radix from 3 * 2^21 u32 and u64 keys
    and from 2^18 16-bit keys."""
    assert sort_mod.AUTO_RADIX_MIN_N == {16: 1 << 18, 32: 3 << 21, 64: 3 << 21}


def test_auto_keeps_a_working_tile_working():
    """Calls that ran before 'auto' took radix still run with their tile."""
    rng = np.random.default_rng(1)
    k = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    want = golden_sort(k)
    for tile in (2, 16, 64, None):
        assert np.array_equal(trt.sort(k, device="cpu", tile=tile).numpy(), want), tile


def _keys(rng, n, dtype):
    if dtype == np.float32:
        k = rng.standard_normal(n).astype(np.float32)
        k[::37] = np.nan
        k[::41] = -np.inf
        k[::43] = -0.0
    elif dtype == ml_dtypes.bfloat16:
        k = rng.standard_normal(n).astype(ml_dtypes.bfloat16)
        k[::37] = np.nan
    elif dtype in (np.int64, np.int16):
        info = np.iinfo(dtype)
        k = rng.integers(info.min, info.max, n, dtype=dtype)
    else:
        k = rng.integers(0, np.iinfo(dtype).max, n, dtype=dtype)
    k[: n // 8] = k[0]  # equal-key runs: stability must hold
    k[n // 8: n // 4] = k[n // 8] & 0xF if k.dtype.kind in "iu" else k[n // 8]
    return k


def _port(k):
    if k.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(k.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(k)


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.ascontiguousarray(x).view(np.uint8)


CASES = {
    "keys only": (np.uint32, False, {}),
    "values_are_ranks": (np.uint32, True, {"values_are_ranks": True}),
    "count < n": (np.uint32, True, {"count": 700}),
    "bit_count=12": (np.uint32, True, {"bit_count": 12}),
    "descending": (np.uint32, True, {"descending": True}),
    "total_order f32": (np.float32, True, {"total_order": True}),
    "check_order sorted": (np.uint32, True, {"check_order": True}),
    "check_order unsorted": (np.uint32, True, {"check_order": True}),
    "uint16": (np.uint16, True, {}),
    "bfloat16": (ml_dtypes.bfloat16, True, {"descending": True}),
    "uint64": (np.uint64, True, {}),
    "int64": (np.int64, True, {"values_are_ranks": True, "count": 900}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_auto_radix_route_matches_golden_and_bitonic(monkeypatch, case):
    """With the threshold at 512 keys, 1,000 keys take the radix engine
    (the spy sees it) and give the golden's bytes and the network's."""
    dtype, with_values, kw = CASES[case]
    low = {16: 512, 32: 512, 64: 512}
    monkeypatch.setattr(sort_mod, "AUTO_RADIX_MIN_N", low)
    calls = []
    real = radix.sort_u32

    def spy(*args, **kwargs):
        calls.append(kwargs.get("check_order", False))
        return real(*args, **kwargs)

    monkeypatch.setattr(radix, "sort_u32", spy)
    n = 1000
    rng = np.random.default_rng(sum(map(ord, case)))
    k = _keys(rng, n, dtype)
    if case == "check_order sorted":
        k = np.sort(k)
    v = np.arange(n, dtype=np.uint32) if kw.get("values_are_ranks") else rng.integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    args = (_port(k), torch.from_numpy(v)) if with_values else (_port(k),)
    gold = golden_sort(k, v if with_values else None,
                       **{a: b for a, b in kw.items() if a not in ("values_are_ranks",
                                                                   "check_order")})
    gold = gold if with_values else (gold,)

    got = trt.sort(*args, device="cpu", **kw)
    got = got if with_values else (got,)
    assert calls and all(c == kw.get("check_order", False) for c in calls), calls
    net = trt.sort(*args, device="cpu", method="bitonic", **kw)
    net = net if with_values else (net,)
    for g, w, b in zip(got, gold, net):
        assert np.array_equal(_bits(g), _bits(w)), case
        assert np.array_equal(_bits(g), _bits(b)), case


def test_auto_below_threshold_takes_the_network(monkeypatch):
    """Below the threshold, and with a count under it in a longer buffer,
    'auto' never calls the radix engine."""
    monkeypatch.setattr(sort_mod, "AUTO_RADIX_MIN_N", {16: 512, 32: 512, 64: 512})
    monkeypatch.setattr(radix, "sort_u32", lambda *a, **k: pytest.fail("radix ran"))
    rng = np.random.default_rng(3)
    k = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(trt.sort(k[:511], device="cpu").numpy(), golden_sort(k[:511]))
    assert np.array_equal(trt.sort(k, device="cpu", count=511).numpy(),
                          golden_sort(k, count=511))
    assert np.array_equal(trt.sort(k[:511], device="cpu", check_order=True).numpy(),
                          golden_sort(k[:511]))


def test_engines_sweep_check_and_threshold():
    """The sweep's byte check of both engines runs on the CPU, and its
    threshold is the least size from which radix wins every larger row, in
    every timing the row has, with and without check_order."""
    from tpu_radix_sort_torch.benchmarks import engines

    assert engines.check("cpu", sizes=(100, 3 << 6)) == 0
    rows = [{"key": "uint32", "payload": p, "n": n, "check_order": False,
             "radix_ms": 1.0, "bitonic_ms": b}
            for p, n, b in (("keys", 1 << 10, 2.0), ("keys", 1 << 11, 0.5),
                            ("keys", 1 << 12, 2.0), ("rank", 1 << 12, 2.0),
                            ("keys", 1 << 13, 3.0), ("rank", 1 << 13, float("nan")))]
    assert engines.threshold(rows, "uint32") is None  # a NaN counts as a loss
    rows[-1]["bitonic_ms"] = 1.5
    assert engines.threshold(rows, "uint32") == 1 << 12
    assert engines.threshold(rows, "uint64") is None
    # a synchronous wall time where radix loses holds the threshold above it
    rows[3].update(radix_wall_ms=1.0, bitonic_wall_ms=0.9)
    assert engines.threshold(rows, "uint32") == 1 << 13
    # so does a check_order row
    rows[3].update(bitonic_wall_ms=1.1)
    rows.append({"key": "uint32", "payload": "keys", "n": 1 << 13, "check_order": True,
                 "radix_ms": 2.0, "bitonic_ms": 1.0})
    assert engines.threshold(rows, "uint32") is None
    assert engines.SIZES[0] == 1 << 10 and engines.SIZES[-1] == 1 << 26
    assert 3 << 24 in engines.SIZES and len(engines.SIZES) == 33
