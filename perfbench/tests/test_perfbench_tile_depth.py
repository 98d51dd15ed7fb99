"""The two cells added with the 3D Gaussian Splatting frame sort: the
program's spans on the 64-bit path in a CPU trace, the readers that give
device time to those spans on a hand-worked trace, the entry held to its
configuration, and whole runs on the CPU, sound and with the timed path
broken."""
import time

import pytest
import torch

import tpu_radix_sort_torch as trs
from perfbench.harness import main, registry, trace
from perfbench.harness.cell import Plan
from perfbench.tests.test_perfbench_faults import _fault
from perfbench.tests.test_perfbench_metrics import _run
from tpu_radix_sort_torch import runtime

SPLAT, ENTROPY = "splat_tile_depth_u64.bicycle", "flat_u32_pairs.entropy0201"
WORD_SPANS = {"radix.lo_word", "radix.hi_word"}


def _spans_of(tmp_path, fn):
    with runtime.trace(str(tmp_path), device="cpu"):
        fn()
    return {e["name"] for e in runtime.profiler.load_events(str(tmp_path))
            if e.get("cat") == "user_annotation"}


def test_a_u64_sort_by_44_bits_shows_the_64_bit_spans(tmp_path):
    keys = torch.randint(-2**62, 2**62, (5000,), generator=torch.Generator().manual_seed(1))
    values = torch.arange(5000, dtype=torch.int32).view(torch.uint32)
    got = _spans_of(tmp_path, lambda: trs.sort(keys.view(torch.uint64), values, bit_count=44,
                                               method="radix"))
    assert got == {"sort64"} | WORD_SPANS
    # the network sorts both words at once: the 64-bit layer's span alone
    got = _spans_of(tmp_path / "b", lambda: trs.sort(keys.view(torch.uint64), values,
                                                     bit_count=44, method="bitonic"))
    assert got == {"sort64"}


@pytest.mark.parametrize("method", ["radix", "bitonic", "auto"])
def test_a_u32_sort_shows_none(tmp_path, method):
    keys = torch.randint(0, 1 << 20, (5000,), generator=torch.Generator().manual_seed(2))
    keys = keys.to(torch.int32).view(torch.uint32)
    values = torch.arange(5000, dtype=torch.int32).view(torch.uint32)
    assert _spans_of(tmp_path, lambda: trs.sort(keys, values, bit_count=20, method=method)) == set()


def _events():
    """A window 0-1,000 us holding two calls. Call 1: sort64 100-400 holds
    radix.lo_word 150-250 and radix.hi_word 260-330; call 2: sort64 500-800,
    lo_word 550-650, hi_word 660-730. Each host launch and the device
    event it started share a correlation id; one launch comes before the
    first span, one after the window."""
    rows = [
        ("user_annotation", trace.WINDOW_SPAN, 0, 1000, {}),
        ("user_annotation", "sort64", 100, 300, {}),
        ("user_annotation", "radix.lo_word", 150, 100, {}),
        ("user_annotation", "radix.hi_word", 260, 70, {}),
        ("user_annotation", "sort64", 500, 300, {}),
        ("user_annotation", "radix.lo_word", 550, 100, {}),
        ("user_annotation", "radix.hi_word", 660, 70, {}),
        # host launches
        ("cuda_runtime", "cudaLaunchKernel", 50, 2, {"correlation": 1}),   # outside sort64
        ("cuda_runtime", "cudaLaunchKernel", 110, 2, {"correlation": 2}),  # sort64 own
        ("cuda_runtime", "cudaLaunchKernel", 160, 2, {"correlation": 3}),  # lo_word
        ("cuda_runtime", "cudaLaunchKernel", 270, 2, {"correlation": 4}),  # hi_word
        ("cuda_runtime", "cudaMemcpyAsync", 350, 2, {"correlation": 5}),   # sort64 own
        ("cuda_driver", "cuLaunchKernel", 560, 2, {"correlation": 6}),     # lo_word
        ("cuda_runtime", "cudaLaunchKernel", 790, 2, {"correlation": 7}),  # sort64 own
        ("cuda_runtime", "cudaLaunchKernel", 1100, 2, {"correlation": 8}),  # after the window
        # device work
        ("kernel", "k_outside", 60, 20, {"correlation": 1}),
        ("kernel", "split_words", 120, 30, {"correlation": 2}),
        ("kernel", "reorder_kernel", 170, 70, {"correlation": 3}),
        ("kernel", "reorder_kernel", 280, 40, {"correlation": 4}),
        ("gpu_memcpy", "Memcpy DtoD", 360, 10, {"correlation": 5}),
        ("kernel", "reorder_kernel", 570, 60, {"correlation": 6}),
        ("kernel", "join_words", 795, 15, {"correlation": 7}),  # runs past its span
        ("kernel", "late", 1110, 5, {"correlation": 8}),
    ]
    return [{"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d, "tid": 1, "args": a}
            for c, n, ts, d, a in rows]


def test_the_64_bit_readers_on_a_hand_worked_trace():
    run = _run(events=_events(), span=(0, 1000, 1), calls=2)
    # own: 30 (split) + 10 (copy) + 15 (join) us over 2 calls
    assert registry.metric("sort64_own_ms").read(run) == pytest.approx(55e-3 / 2)
    # words: 70 + 40 + 60 us over 2 calls
    assert registry.metric("word_sort_ms").read(run) == pytest.approx(170e-3 / 2)


def test_the_64_bit_readers_find_nothing_without_the_spans_or_the_card():
    parent = [e for e in _events() if e["name"] not in {"sort64"} | WORD_SPANS]
    cpu = [e for e in _events() if e["cat"] not in trace.DEVICE_CATEGORIES]
    for events in (parent, cpu, None):
        run = _run(events=events, span=None if events is None else (0, 1000, 1), calls=2)
        assert registry.metric("sort64_own_ms").read(run) is None
        assert registry.metric("word_sort_ms").read(run) is None


def test_the_entry_and_reference_sort_by_the_configurations_bits():
    bench = registry.benchmark()
    cfg = registry.config(bench, registry.cell(bench, SPLAT)["config"])
    assert cfg["kind"] == "tile_depth_pairs" and cfg["key_dtype"] == "uint64"
    assert registry.module("entries", cfg["kind"]).BIT_COUNT == cfg["bit_count"]
    assert registry.module("reference", cfg["kind"]).BIT_COUNT == cfg["bit_count"]
    assert cfg["n"] % 4096 and cfg["reduced"] == []
    traffic = registry.traffic(registry.cell(bench, SPLAT)["traffic"])
    tiles = 1
    for side in registry.module("keys", "tile_depth").grid(traffic["keys"]):
        tiles *= side
    assert cfg["bit_count"] == 32 + tiles.bit_length()  # the source's 32 + getHigherMsb(tiles)


def _plan(cell_name, n, *, entry_file=None):
    bench = registry.benchmark()
    cell = registry.cell(bench, cell_name)
    cfg = dict(registry.config(bench, cell["config"]), n=n)
    tr = registry.traffic(cell["traffic"])
    if "batch" in tr["keys"]:  # fewer Gaussians a draw than the frame's, as the CPU is slow
        tr = dict(tr, keys=dict(tr["keys"], batch=4096))
    return Plan(cell=cell, config=cfg, traffic=tr,
                metrics=registry.cell_metrics(bench, cell_name, False), seed=2**31 + 91,
                seconds=1.0, trace=False, t0=time.perf_counter(), device_type="cpu",
                entry_file=entry_file)


CELLS = [(SPLAT, 6_001), (ENTROPY, 1 << 12)]


@pytest.mark.parametrize("cell_name,n", CELLS)
def test_a_sound_run_is_correct(cell_name, n):
    result = main.execute(_plan(cell_name, n))
    assert result["correct"], result["compared"]
    assert all(c["value"] == 0 for c in result["compared"].values())


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered", "sorted_in_place"])
@pytest.mark.parametrize("cell_name,n", CELLS)
def test_a_broken_timed_path_is_not_correct(tmp_path, cell_name, n, fault):
    bench = registry.benchmark()
    kind = registry.config(bench, registry.cell(bench, cell_name)["config"])["kind"]
    result = main.execute(_plan(cell_name, n, entry_file=_fault(tmp_path, fault, kind)))
    assert not result["correct"], result["compared"]
