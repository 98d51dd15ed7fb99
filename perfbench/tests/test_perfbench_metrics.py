"""The metric arithmetic on hand-worked values: the percentile over all
calls, busy share, idle gaps and device operations of a synthetic trace,
and each reader."""
import numpy as np
import pytest
import torch

from perfbench.harness import cell, registry, trace
from perfbench.harness.cell import RankRun


def test_percentile_is_over_all_calls():
    ms = [float(x) for x in range(1, 21)]
    p95 = registry.metric("call_p95_ms")
    assert p95.read(_run(latencies=[x / 1e3 for x in ms])) == pytest.approx(19.05)
    assert p95.read(_run(latencies=[x / 1e3 for x in ms[::-1]])) == pytest.approx(19.05)
    rng = np.random.default_rng(0)
    ys = rng.exponential(size=977).tolist()
    assert p95.read(_run(latencies=ys)) == pytest.approx(1e3 * float(np.percentile(ys, 95)))
    assert p95.read(_run(latencies=[0.004])) == pytest.approx(4.0)


def _events():
    """A window 0-100 us on thread 1; kernels 10-30 and 20-40 overlap, one
    60-70, a copy 80-85; a host op 0-50 holds a launch 45-47."""
    rows = [
        ("user_annotation", trace.WINDOW_SPAN, 0, 100, 1),
        ("user_annotation", "perfbench.call", 0, 99, 1),
        ("cpu_op", "aten::a", 0, 50, 1),
        ("cuda_runtime", "cudaLaunchKernel", 45, 2, 1),
        ("cpu_op", "other_thread", 0, 100, 2),
        ("kernel", "void ns::k1<2, 3>(int*)", 10, 20, None),
        ("kernel", "void k1<1>(int)", 20, 20, None),
        ("kernel", "ncclDevKernel_SendRecv(x)", 60, 10, None),
        ("gpu_memcpy", "Memcpy DtoD", 80, 5, None),
        ("kernel", "outside", 95, 50, None),
    ]
    return [{"ph": "X", "cat": c, "name": n, "ts": ts, "dur": d, "tid": t}
            for c, n, ts, d, t in rows]


def test_busy_share_and_device_ops_of_a_synthetic_trace():
    ev = _events()
    lo, hi, tid = trace.span(ev)
    assert (lo, hi, tid) == (0, 100, 1)
    assert trace.busy_us(ev, lo, hi) == 30 + 10 + 5 + 5
    assert trace.busy_us(ev, lo, hi, keep=lambda n: "nccl" in n.lower()) == 10
    assert trace.device_ops(ev, lo, hi) == [
        ["k1", 40e-6], ["ncclDevKernel_SendRecv", 10e-6], ["Memcpy DtoD", 5e-6], ["outside", 5e-6]]


def test_idle_gaps_by_what_the_host_was_doing():
    ev = _events()
    # gaps 0-10 (aten::a), 40-60 (middle 50: aten::a has ended, the call
    # holds it), 70-80 and 85-95 (the call)
    assert trace.idle_gaps(ev, 0, 100, thread=1) == [
        ["perfbench.call", 40e-6], ["aten::a", 10e-6]]
    assert trace.idle_gaps(ev, 0, 100, thread=2) == [["other_thread", 50e-6]]


def _run(**kw):
    base = dict(rank=0, world=1, config={}, keys_per_call=1 << 20, bytes_per_call=3_350_000,
                t0=10.0, first_call=22.5, latencies=[0.001 * i for i in range(1, 21)],
                enqueue=[0.002, 0.004], window_s=2.0, calls=3, launches=273,
                mem_base=1 << 30, mem_peak=(1 << 30) + (3 << 29), events=_events(),
                span=(0, 100, 1), peak={"hbm_bytes_per_s": 3.35e12})
    base.update(kw)
    return RankRun(**base)


def _read(name, run):
    return registry.metric(name).read(run)


def test_every_reader_on_hand_worked_values():
    run = _run()
    assert _read("keys_per_s", run) == pytest.approx(3 * (1 << 20) / 2.0 / 1e9)
    assert _read("call_p95_ms", run) == pytest.approx(19.05)
    assert _read("peak_mem_gib", run) == pytest.approx(1.5)
    assert _read("setup_s", run) == pytest.approx(12.5)
    assert _read("host_enqueue_ms", run) == pytest.approx(3.0)
    assert _read("launches_per_call", run) == 91
    # least time 1 us a call; busy 50 us over 3 calls
    assert _read("sort_roofline", run) == pytest.approx(100 * 1.0 / (50 / 3))
    assert _read("device_idle_pct", run) == pytest.approx(50.0)
    assert _read("collective_ms_per_call", run) is None  # one rank
    assert _read("collective_ms_per_call", _run(world=4)) == pytest.approx(10e-3 / 3)


def test_readers_find_nothing_where_there_is_nothing():
    run = _run(events=None, span=None, launches=None, mem_peak=None, mem_base=None)
    for name in ("sort_roofline", "device_idle_pct", "collective_ms_per_call",
                 "launches_per_call", "peak_mem_gib"):
        assert _read(name, run) is None
    assert _read("sort_roofline", _run(peak=None)) is None
    quiet = [e for e in _events() if e["cat"] not in trace.DEVICE_CATEGORIES]
    assert _read("sort_roofline", _run(events=quiet)) is None
    assert _read("device_idle_pct", _run(events=quiet)) is None


def test_roofline_bytes_come_from_the_shapes():
    n = 1 << 10
    ins = {"keys": torch.zeros(n, dtype=torch.int32).view(torch.uint32),
           "values": torch.zeros(n, dtype=torch.int32),
           "offsets": torch.zeros(5, dtype=torch.int64)}
    outs = {"keys": torch.zeros(n, dtype=torch.int32), "values": torch.zeros(n, dtype=torch.int32)}
    assert cell.call_bytes(ins, outs) == 16 * n + 40
