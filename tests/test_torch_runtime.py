"""Port parity of ``runtime/``: the native CPU baseline against the JAX
package's ``runtime.cpu_baseline`` and numpy on the same seeded keys, byte
for byte; the profiler's trace, spans and the readers of a written trace;
the runtime package's exports."""
import json
import os
import tempfile

import numpy as np
import pytest
import torch

from tpu_radix_sort.runtime import cpu_baseline as jax_cpu
from tpu_radix_sort_torch import runtime
from tpu_radix_sort_torch.runtime import cpu_baseline, profiler


@pytest.fixture(autouse=True)
def _private_jax_native_cache(tmp_path, monkeypatch):
    """The JAX baseline builds to a fixed path that the JAX package's own
    runtime test also builds; a private cache keeps the two apart when they
    run in parallel workers."""
    monkeypatch.setenv("TRS_NATIVE_CACHE", str(tmp_path / "jax_native"))


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n", [0, 1, 2, 257, 10_007])
@pytest.mark.parametrize("with_values", [False, True])
def test_cpu_sort_matches_jax_and_numpy(n, with_values):
    k = _keys(n, n)
    k[: n // 3] = k[0] if n else k[: n // 3]  # a run of ties: stability shows
    v = np.random.default_rng(n + 1).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    order = np.argsort(k, kind="stable")
    if with_values:
        got, want = cpu_baseline.cpu_sort(k, v), jax_cpu.cpu_sort(k, v)
        for g, w, ref in zip(got, want, (k[order], v[order])):
            assert g.dtype == np.uint32 and np.array_equal(g, w) and np.array_equal(g, ref)
    else:
        got = cpu_baseline.cpu_sort(k)
        assert got.dtype == np.uint32
        assert np.array_equal(got, jax_cpu.cpu_sort(k)) and np.array_equal(got, k[order])


def test_cpu_sort_leaves_inputs_and_numpy_fallback_agrees(monkeypatch):
    k, v = _keys(3, 4099), np.arange(4099, dtype=np.uint32)
    k0, v0 = k.copy(), v.copy()
    native = cpu_baseline.cpu_sort(k, v)
    assert np.array_equal(k, k0) and np.array_equal(v, v0)
    monkeypatch.setattr(cpu_baseline, "_get_lib", lambda: None)
    assert cpu_baseline.sort_kind() == "numpy"
    fallback = cpu_baseline.cpu_sort(k, v)
    assert all(np.array_equal(a, b) for a, b in zip(native, fallback))
    assert cpu_baseline.cpu_disorder_count(k) == jax_cpu.cpu_disorder_count(k)


@pytest.mark.parametrize("case", ["random", "sorted", "reversed", "single", "empty"])
def test_cpu_disorder_count_matches_jax(case):
    k = {"random": _keys(5, 3001), "sorted": np.sort(_keys(6, 3001)),
         "reversed": np.sort(_keys(7, 3001))[::-1], "single": _keys(8, 1),
         "empty": _keys(9, 0)}[case]
    want = int(np.sum(k[:-1] > k[1:])) if k.size > 1 else 0
    assert cpu_baseline.cpu_disorder_count(k) == jax_cpu.cpu_disorder_count(k) == want


def test_native_available_in_its_own_build_dir():
    assert cpu_baseline.native_available()
    assert cpu_baseline.sort_kind() == "native radix"
    path = cpu_baseline.library_path()
    assert path.exists() and path.parent == cpu_baseline.BUILD_DIR
    assert path.parent.parts[-3:] == ("tpu_radix_sort_torch", "build", "native")


def test_library_path_differs_from_jax():
    """The JAX baseline builds $TRS_NATIVE_CACHE (default <tmp>/trs_native)
    /libtrs_sort.so; the port's library has a name and directory of its own."""
    path = cpu_baseline.library_path()
    assert path.name.startswith("libtrs_torch_sort-") and path.name != "libtrs_sort.so"
    for cache in (os.environ["TRS_NATIVE_CACHE"], os.path.join(tempfile.gettempdir(),
                                                               "trs_native")):
        assert str(path.parent) != os.path.abspath(cache)


def test_trace_cpu_writes_annotate_span(tmp_path):
    with runtime.trace(str(tmp_path), device="cpu") as log_dir:
        with runtime.annotate("sort"):
            torch.sort(torch.arange(1000, 0, -1))
    assert log_dir == str(tmp_path)
    with open(tmp_path / "trace.json") as f:
        data = json.load(f)
    events = profiler.load_events(str(tmp_path))
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "sort"]
    assert "traceEvents" in data and len(spans) == 1
    lo, hi = profiler.span(events, "sort")
    assert hi > lo
    ops = [e for e in events if e.get("cat") == "cpu_op" and "sort" in e["name"]]
    assert ops and all(lo <= e["ts"] <= hi for e in ops)
    # host activity only: no device event, so no busy time
    assert profiler.busy_share(events, "sort")["device_events"] == 0


def test_trace_default_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("TRS_TRACE_DIR", str(tmp_path / "env"))
    assert profiler.default_log_dir() == str(tmp_path / "env")
    with runtime.trace(device="cpu") as d:
        pass
    assert d == str(tmp_path / "env") and os.path.exists(os.path.join(d, "trace.json"))
    monkeypatch.delenv("TRS_TRACE_DIR")
    assert profiler.default_log_dir() == os.path.join(tempfile.gettempdir(), "trs_torch_trace")


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the CPU-only behaviour")
def test_trace_without_cuda_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with runtime.trace(str(tmp_path)):
            pass
    assert not (tmp_path / "trace.json").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the CPU-only behaviour")
def test_annotate_pushes_no_nvtx_on_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: calls.append(name))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: calls.append("pop"))
    with runtime.annotate("span"):
        pass
    assert calls == []


def test_annotate_pushes_and_pops_nvtx_where_cuda(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: calls.append(name))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: calls.append("pop"))
    with pytest.raises(ValueError):
        with runtime.annotate("span"):
            raise ValueError
    assert calls == ["span", "pop"]


def test_runtime_exports():
    from tpu_radix_sort import runtime as jax_runtime
    from tpu_radix_sort_torch.runtime.timing import device_time

    assert runtime.__all__ == jax_runtime.__all__ == ["device_time", "trace", "annotate"]
    assert runtime.device_time is device_time
    assert runtime.trace is profiler.trace and runtime.annotate is profiler.annotate


def _ev(cat, ts, dur, name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_share_is_the_clipped_union():
    events = [_ev("user_annotation", 100, 100, "sort"),
              _ev("kernel", 90, 20),  # clipped to 100-110
              _ev("kernel", 105, 10),  # overlaps: 110-115 new
              _ev("gpu_memcpy", 150, 10),
              _ev("gpu_memset", 190, 30),  # clipped to 190-200
              _ev("kernel", 250, 10),  # outside the span
              _ev("cpu_op", 120, 50)]  # host work is not the card's
    got = profiler.busy_share(events, "sort")
    assert got["busy_ms"] == pytest.approx(35 / 1e3)
    assert got["busy_share"] == pytest.approx(0.35)
    assert got["span_ms"] == pytest.approx(0.1) and got["device_events"] == 4
    with pytest.raises(ValueError, match="2 host spans"):
        profiler.busy_share(events + [_ev("user_annotation", 0, 1, "sort")], "sort")


def test_kernel_counts_by_function_name():
    names = ["bitonic_tile_kernel", "scan_kernel", "disorder_kernel"]
    events = [
        _ev("kernel", 0, 1, "void (anonymous namespace)::bitonic_tile_kernel<2, 2>"
                            "(unsigned int*, unsigned int, unsigned int, unsigned int, "
                            "(anonymous namespace)::StageList)"),
        _ev("kernel", 0, 1, "(anonymous namespace)::scan_kernel(unsigned int const*, "
                            "unsigned long long, int)"),
        _ev("kernel", 0, 1, "void chained_scan_kernel<AddU32>(unsigned int*)"),
        _ev("kernel", 0, 1, "disorder_cols_kernel(unsigned int const*)"),
        _ev("kernel", 0, 1, "void at::native::vectorized_elementwise_kernel<4, "
                            "at::native::FillFunctor<int>>(int, at::native::FillFunctor<int>)"),
        _ev("cpu_op", 0, 1, "bitonic_tile_kernel(x)"),
    ]
    assert profiler.kernel_counts(events, names) == {
        "bitonic_tile_kernel": 1, "scan_kernel": 1, "disorder_kernel": 0}
    assert profiler.kernel_name("_ZN12_GLOBAL__N_111scan_kernelEPKjyi") == (
        "_ZN12_GLOBAL__N_111scan_kernelEPKjyi")
