#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

It builds the kernels from ``tpu_radix_sort_torch/csrc`` (nvcc, sm_90a),
holds each kernel against its plain PyTorch version on the card, drives the
public entry points at the headline size (bench.py's 2^26 u32 key + rank
payload) through both sort engines (the bitonic network and
``method='radix'``), the mid-sort early exit, ``prefix_sum`` and the other
options, checks every result byte for byte, times the sorts, the scan, each
kernel, its plain version and ``torch.sort``/``torch.cumsum``, and prints:

- the card's name and power limit (``nvidia-smi``) and the build's register
  and shared-memory lines;
- one line per check;
- one JSON line ``{"kernels": [...]}``;
- last, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero. It also exits
non-zero without printing a result where ``torch.cuda.is_available()`` is
false or the package is not beside it. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# No 32-bit integer rate is in the data sheet's table; its float32 rate
# outside the tensor cores stands for the card's 32-bit ALU peak.
ALU_OPS_PER_S = 67e12
HEADLINE_N = 1 << 26
SPLIT_N = 40_000_000
OPTION_N = 1 << 22
SMALL_N = (1 << 16) + 3
SEED = 20261016
# The TPU kernel each CUDA kernel replaces (the Pallas kernel function).
REPLACES = {
    "bitonic_tile_kernel": "tpu_radix_sort/ops/bitonic.py:267",
    "bitonic_global_stage_kernel": "tpu_radix_sort/ops/bitonic.py:267",
    "disorder_kernel": "tpu_radix_sort/ops/checksort.py:39",
    "scan_kernel": "tpu_radix_sort/ops/scan.py:71",
    "digit_histogram_kernel": "tpu_radix_sort/ops/radix.py:57",
    "reorder_kernel": "tpu_radix_sort/ops/radix.py:129",
}


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)
    print(f"check ok: {what}", flush=True)


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def u32_err(a, b):
    """Largest |a - b| over two int32 tensors read as u32 patterns."""
    import torch

    if a.numel() == 0:
        return 0
    d = (a.to(torch.int64) & 0xFFFFFFFF) - (b.to(torch.int64) & 0xFFFFFFFF)
    return int(d.abs().max())


def same(a, b):
    """Byte equality of two tensors of 4-byte elements (any dtype)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def timed(fn, events):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    events.append((start, end))
    return out


def elapsed_ms(events):
    import torch

    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        import tpu_radix_sort_torch as trt
        from tpu_radix_sort_torch import _build
        from tpu_radix_sort_torch.models.golden import golden_prefix_sum, golden_sort
        from tpu_radix_sort_torch.ops import bitonic, checksort, common, radix, scan
        from tpu_radix_sort_torch.runtime.timing import device_time
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    run(torch.device("cuda"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev) -> None:
    """Every phase on device `dev`; raises CheckFailed on any mismatch."""
    import torch

    import tpu_radix_sort_torch as trt
    from tpu_radix_sort_torch import _build
    from tpu_radix_sort_torch.models.golden import golden_prefix_sum, golden_sort
    from tpu_radix_sort_torch.ops import bitonic, checksort, common, radix, scan
    from tpu_radix_sort_torch.runtime.timing import device_time

    t_start = time.perf_counter()

    # ---- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in sorted(logs.items()):
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "Used" in line and entry:
                print(f"ptxas {name}: {entry}: {line.split(':', 1)[1].strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def rand_u32(n, hi=None):
        if hi is None:
            x = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                              device=dev, generator=gen)
        else:
            x = torch.randint(0, hi, (n,), dtype=torch.int32, device=dev,
                              generator=gen)
        return x.view(torch.uint32)

    max_err = {k.name: 0 for k in _build.KERNELS}

    # ---- kernels vs plain versions, small shapes ---------------------------
    for n_arr, n_keys in ((1, 1), (2, 2), (3, 2), (4, 2)):
        n, tile = 1 << 16, 1024
        x = torch.stack([rand_u32(n, 1 << 12).view(torch.int32)]
                        + [rand_u32(n).view(torch.int32) for _ in range(n_arr - 1)])
        if n_keys == 2:
            x[1] = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
        for call in bitonic.sort_schedule(n, tile):
            got = bitonic.run_schedule(x.clone(), [call], n_keys=n_keys, tile=tile)
            stages = call[1] if call[0] == "tile" else [call[1:]]
            want = bitonic.stages_plain(x.clone(), stages, n_keys)
            err = u32_err(got, want)
            name = ("bitonic_tile_kernel" if call[0] == "tile"
                    else "bitonic_global_stage_kernel")
            max_err[name] = max(max_err[name], err)
            if err:
                raise CheckFailed(f"K1 {call[0]} call differs from plain, cols {(n_arr, n_keys)}")
            x = got
        keys = x[:n_keys].cpu().numpy().view(np.uint32)
        check(np.array_equal(np.lexsort(keys[::-1]), np.arange(n)),
              f"K1 == plain per call and sorted, cols {(n_arr, n_keys)}, n 2^16, tile {tile}")
    n = (1 << 24) + 3
    base = rand_u32(n)
    srt = torch.sort(common.bias_i32(base.view(torch.int32)))[0]
    srt = common.bias_i32(srt)
    for label, u in (("sorted", srt), ("reversed", srt.flip(0)),
                     ("random", base.view(torch.int32))):
        got = checksort.disorder_kernel(u)
        want = checksort.disorder_plain(u)
        max_err["disorder_kernel"] = max(max_err["disorder_kernel"], u32_err(got, want))
        check(same(got, want), f"K2 == plain on {label} u32, n 2^24+3 "
              f"(count {int(got.view(torch.uint32)[0])})")
    del base, srt

    table_n = radix.R * common.cdiv(HEADLINE_N, radix.DEFAULT_TILE)
    scan_sizes = (1, scan.SCAN_TILE, scan.SCAN_TILE + 1, SMALL_N, table_n)
    for n in scan_sizes:
        u = rand_u32(n).view(torch.int32)
        for inclusive in (False, True):
            err = u32_err(scan.scan_kernel(u, inclusive=inclusive),
                          scan.scan_plain(u, inclusive=inclusive))
            max_err["scan_kernel"] = max(max_err["scan_kernel"], err)
            if err:
                raise CheckFailed(f"K4 differs from plain, n {n}, inclusive {inclusive}")
    check(max_err["scan_kernel"] == 0,
          f"K4 == plain, exclusive and inclusive, n in {scan_sizes}")
    for n_arr in (1, 2, 3, 4):
        x = torch.stack([rand_u32(SMALL_N).view(torch.int32) for _ in range(n_arr)])
        for keys_kind in ("random", "all-equal"):
            if keys_kind == "all-equal":
                x[0] = common.i32(0xDEADBEEF)
            for bit in (0, 2, 16, 30):
                for tile in (radix.DEFAULT_TILE, 128):
                    hist = radix.digit_histogram(x[0], bit=bit, tile=tile)
                    err_h = u32_err(hist, radix.digit_histogram_plain(x[0], bit=bit, tile=tile))
                    offs = radix.bucket_offsets(hist)
                    got = radix.reorder_pass(x, offs, bit=bit, tile=tile)
                    want = radix.reorder_pass_plain(x, offs, bit=bit, tile=tile,
                                                    out=torch.empty_like(x))
                    err_r = u32_err(got, want)
                    max_err["digit_histogram_kernel"] = max(max_err["digit_histogram_kernel"], err_h)
                    max_err["reorder_kernel"] = max(max_err["reorder_kernel"], err_r)
                    if err_h or err_r:
                        raise CheckFailed(f"K5/K6 differ from plain: {n_arr} columns, "
                                          f"{keys_kind} keys, bit {bit}, tile {tile}")
        check(True, f"K5 and K6 == plain, {n_arr} columns, n 2^16+3, random and all-equal "
              f"keys, bits 0/2/16/30, tiles {radix.DEFAULT_TILE} and 128")
    del x, got, want

    # ---- the main path -----------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    per_case = {}

    def drive(label, fn):
        before = _build.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        after = _build.launch_counts()
        per_case[label] = {k: after[k] - before[k] for k in after}
        print(f"launches {label}: {json.dumps(per_case[label])}", flush=True)
        return out

    def torch_ref(keys_u32):
        sk, idx = torch.sort(common.bias_i32(keys_u32.view(torch.int32)), stable=True)
        return common.bias_i32(sk).view(torch.uint32), idx.to(torch.int32).view(torch.uint32)

    keys = rand_u32(HEADLINE_N)
    iota = torch.arange(HEADLINE_N, dtype=torch.int32, device=dev).view(torch.uint32)
    ok, ov = drive("headline k+v 2^26",
                   lambda: trt.sort(keys, iota, values_are_ranks=True))
    rk, rv = torch_ref(keys)
    check(same(ok, rk) and same(ov, rv),
          "sort(keys, iota, values_are_ranks=True), 2^26 u32 == torch.sort(stable=True)")
    peak_headline = torch.cuda.max_memory_allocated()
    ko = drive("keys-only 2^26", lambda: trt.sort(keys))
    check(same(ko, rk), "keys-only sort, 2^26 u32 == torch.sort")
    del ko

    sk = rand_u32(SPLIT_N, 1 << 20)
    sv = torch.arange(SPLIT_N, dtype=torch.int32, device=dev).view(torch.uint32)
    sok, sov = drive("split k+v 40M", lambda: trt.sort(sk, sv, values_are_ranks=True))
    gk, gv = golden_sort(sk.cpu().numpy(), sv.cpu().numpy())
    check(np.array_equal(sok.cpu().numpy(), gk) and np.array_equal(sov.cpu().numpy(), gv),
          "sort of n = 40,000,000 (split path: prefix + remainder + merge) == golden")
    del sk, sv, sok, sov, gk, gv

    cok, cov = drive("check_order sorted 2^26", lambda: trt.sort(
        ok, ov, values_are_ranks=True, check_order=True))
    d = per_case["check_order sorted 2^26"]
    check(same(cok, ok) and same(cov, ov) and d["disorder_kernel"] == 2
          and d["bitonic_tile_kernel"] == 0 and d["bitonic_global_stage_kernel"] == 0,
          "check_order=True on sorted input: K2 gates, K1 does not run")
    del cok, cov
    small = keys[:OPTION_N]
    uok = drive("check_order unsorted 2^22", lambda: trt.sort(small, check_order=True))
    d = per_case["check_order unsorted 2^22"]
    check(same(uok, torch_ref(small)[0]) and d["disorder_kernel"] >= 1
          and d["bitonic_tile_kernel"] >= 1,
          "check_order=True on unsorted input: K2 gates, K1 sorts")

    hk = small.cpu().numpy() >> np.uint32(20)  # 4096 distinct: many ties
    hv = np.arange(OPTION_N, dtype=np.uint32)
    f = np.random.default_rng(SEED).standard_normal(OPTION_N).astype(np.float32)
    f[::97] = np.nan
    f[::101] = -np.inf
    cnt = OPTION_N * 3 // 4 + 1
    cases = [
        ("count < n", dict(count=cnt), hk, hv, dict(count=cnt)),
        ("bit_count=16", dict(bit_count=16), small.cpu().numpy(), None, dict(bit_count=16)),
        ("descending", dict(descending=True), hk, hv, dict(descending=True)),
        ("total_order f32", dict(total_order=True), f, hv, dict(total_order=True)),
    ]
    for method in ("auto", "radix"):
        for label, kw, k_np, v_np, gkw in cases:
            args = (k_np,) if v_np is None else (k_np, v_np)
            out = drive(f"{label} {method} 2^22", lambda: trt.sort(*args, method=method, **kw))
            want = golden_sort(*args, **gkw)
            if v_np is None:
                good = np.array_equal(out.cpu().numpy().view(np.uint32),
                                      want.view(np.uint32))
            else:
                good = all(np.array_equal(o.cpu().numpy().view(np.uint32), w.view(np.uint32))
                           for o, w in zip(out, want))
            check(good, f"sort {label}, method {method}, 2^22 == golden")

    # the radix engine at the headline size (values_are_ranks does not apply)
    rok, rov = drive("radix k+v 2^26", lambda: trt.sort(keys, iota, method="radix"))
    check(same(rok, rk) and same(rov, rv),
          "sort(keys, iota, method='radix'), 2^26 u32 == torch.sort(stable=True)")
    del rok, rov
    rko = drive("radix keys-only 2^26", lambda: trt.sort(keys, method="radix"))
    check(same(rko, rk), "sort(keys, method='radix'), 2^26 u32 == torch.sort")
    del rko
    # the mid-sort early exit: one K5 and one K6 launch per pass that runs
    k16 = (keys.view(torch.int32) & 15).view(torch.uint32)
    passes = {}
    for label, k_in, want, n_pass in (("sorted", rk, rk, 0),
                                      ("keys < 16", k16, torch_ref(k16)[0], 2),
                                      ("random", keys, rk, 16)):
        case = f"radix check_order {label} 2^26"
        out = drive(case, lambda: trt.sort(k_in, method="radix", check_order=True))
        d = per_case[case]
        passes[label] = d["digit_histogram_kernel"]
        check(same(out, want) and d["digit_histogram_kernel"] == n_pass
              and d["reorder_kernel"] == n_pass and d["disorder_kernel"] >= 1,
              f"radix check_order=True on {label} keys, 2^26: {n_pass} passes "
              f"(K2 {d['disorder_kernel']} launches)")
    del k16, out

    # prefix_sum at the headline size
    pu = rand_u32(HEADLINE_N)
    for dtype in (torch.uint32, torch.int32):
        for inclusive in (False, True):
            got = drive(f"prefix_sum {dtype} inclusive={inclusive} 2^26",
                        lambda: trt.prefix_sum(pu.view(dtype), inclusive=inclusive))
            want = scan.scan_plain(pu.view(torch.int32), inclusive=inclusive)
            err = u32_err(got.view(torch.int32), want)
            max_err["scan_kernel"] = max(max_err["scan_kernel"], err)
            check(got.dtype == dtype and err == 0,
                  f"prefix_sum {dtype}, inclusive={inclusive}, 2^26 == plain scan")
    del got, want
    pcnt = HEADLINE_N * 3 // 4 + 1
    got = drive("prefix_sum count < n 2^26", lambda: trt.prefix_sum(pu, count=pcnt))
    check(np.array_equal(got.cpu().numpy(), golden_prefix_sum(pu.cpu().numpy(), count=pcnt)),
          f"prefix_sum(count={pcnt}), 2^26 u32 == golden")
    del got
    main_counts = _build.launch_counts()
    print(f"launches main path: {json.dumps(main_counts)}", flush=True)
    for name, c in main_counts.items():
        check(c > 0, f"{name} launched on the main path ({c})")
    del small

    # ---- times ------------------------------------------------------------
    sort_ms = device_time(lambda k, v: trt.sort(k, v, values_are_ranks=True),
                          keys, iota, warmup=2, iters=10) * 1e3
    keys_only_ms = device_time(trt.sort, keys, warmup=2, iters=10) * 1e3
    lib_ms = device_time(
        lambda k: torch.sort(common.bias_i32(k.view(torch.int32)), stable=True),
        keys, warmup=2, iters=10) * 1e3
    gate_ms = device_time(trt.is_sorted, ok, warmup=2, iters=10) * 1e3
    radix_ms = device_time(lambda k, v: trt.sort(k, v, method="radix"),
                           keys, iota, warmup=2, iters=10) * 1e3
    radix_keys_only_ms = device_time(lambda k: trt.sort(k, method="radix"),
                                     keys, warmup=2, iters=10) * 1e3
    prefix_ms = device_time(trt.prefix_sum, pu, warmup=2, iters=10) * 1e3

    # Replay the headline sort's network (2 columns: key, rank) call by call,
    # each call on the same input through the kernel and the plain version.
    # The least bytes a call must move on this data: every key column read
    # once, and for each element the call moves, its other columns read and
    # all its columns written (an element left in place needs no write).
    n_arr, n_keys = 2, 2
    tile = bitonic.resolve_tile(HEADLINE_N, n_arr)
    x = torch.stack([keys.view(torch.int32), iota.view(torch.int32)])
    kind_name = {"tile": "bitonic_tile_kernel", "global": "bitonic_global_stage_kernel"}
    acc = {k.name: {"k": [], "p": [], "bytes": 0, "ops": 0} for k in _build.KERNELS}
    for call in bitonic.sort_schedule(HEADLINE_N, tile):
        name = kind_name[call[0]]
        a = acc[name]
        stages = call[1] if call[0] == "tile" else [call[1:]]
        want = timed(lambda: bitonic.stages_plain(x.clone(), stages, n_keys), a["p"])
        got = x.clone()
        timed(lambda: bitonic.run_schedule(got, [call], n_keys=n_keys, tile=tile), a["k"])
        err = u32_err(got, want)
        max_err[name] = max(max_err[name], err)
        if err:
            raise CheckFailed(f"K1 {call} differs from plain at 2^26")
        moved = int((got != x).any(dim=0).sum())
        a["bytes"] += (n_keys * 4 * HEADLINE_N + moved * (n_arr - n_keys) * 4
                       + moved * n_arr * 4)
        a["ops"] += len(stages) * (HEADLINE_N // 2) * n_keys
        x = got
        del want
    check(same(x[0], rk) and same(x[1], rv),
          f"K1 == plain per call on the headline network (2^26, 2 columns, tile {tile})")
    del x
    u = ok.view(torch.int32)
    f_ = checksort.FAST_CHECK_ELEMENTS
    a = acc["disorder_kernel"]
    for part in (u[:f_], u[f_ - 1:]):
        got = timed(lambda: checksort.disorder_kernel(part), a["k"])
        want = timed(lambda: checksort.disorder_plain(part), a["p"])
        max_err["disorder_kernel"] = max(max_err["disorder_kernel"], u32_err(got, want))
        a["bytes"] += 4 * part.numel() + 4
        a["ops"] += part.numel() - 1
    check(max_err["disorder_kernel"] == 0, "K2 == plain on the gate's two calls at 2^26")

    rows = {}
    for name in ("bitonic_tile_kernel", "bitonic_global_stage_kernel", "disorder_kernel"):
        a = acc[name]
        k_ms, p_ms = elapsed_ms(a["k"]), elapsed_ms(a["p"])
        calls = len(k_ms)
        print(json.dumps({"calls_of": name, "calls": calls, "ms_sum": sum(k_ms),
                          "ms_min": min(k_ms), "ms_max": max(k_ms),
                          "plain_ms_sum": sum(p_ms),
                          "bound_ms_sum": bound(a["bytes"], a["ops"])[0],
                          "ms_each": k_ms if calls <= 4 else None}))
        rows[name] = dict(ms=sum(k_ms) / calls, plain_ms=sum(p_ms) / calls,
                          bytes=a["bytes"] / calls, ops=a["ops"] / calls, library_ms=None)

    # Replay the headline radix sort (key, iota) pass by pass, each kernel
    # call on the same input as its plain version.
    rtile = radix.DEFAULT_TILE
    xr = torch.stack([keys.view(torch.int32), iota.view(torch.int32)])
    yr = torch.empty_like(xr)
    for i in range(32 // radix.RADIX_BITS):
        bit = i * radix.RADIX_BITS
        hist = radix.digit_histogram(xr[0], bit=bit, tile=rtile)
        max_err["digit_histogram_kernel"] = max(
            max_err["digit_histogram_kernel"],
            u32_err(hist, radix.digit_histogram_plain(xr[0], bit=bit, tile=rtile)))
        offs = radix.bucket_offsets(hist)
        max_err["scan_kernel"] = max(max_err["scan_kernel"], u32_err(
            offs.reshape(-1), scan.scan_plain(hist.reshape(-1))))
        radix.reorder_pass(xr, offs, bit=bit, tile=rtile, out=yr)
        want = radix.reorder_pass_plain(xr, offs, bit=bit, tile=rtile, out=torch.empty_like(xr))
        max_err["reorder_kernel"] = max(max_err["reorder_kernel"], u32_err(yr, want))
        xr, yr = yr, xr
        del want
    check(max_err["digit_histogram_kernel"] == 0 and max_err["reorder_kernel"] == 0
          and max_err["scan_kernel"] == 0 and same(xr[0], rk) and same(xr[1], rv),
          f"K5, K4 and K6 == plain per pass on the headline radix sort (2^26, 2 columns, "
          f"tile {rtile})")

    # Per-call times at the headline shapes, back to back after a warm-up
    # (pass 0 of the headline radix sort; K4 as the public scan of 2^26).
    def ms(fn, *args, iters=20):
        return device_time(fn, *args, warmup=2, iters=iters) * 1e3

    n = HEADLINE_N
    u0 = keys.view(torch.int32)
    xr = torch.stack([u0, iota.view(torch.int32)])
    hist0 = radix.digit_histogram(u0, bit=0, tile=rtile)
    offs0 = radix.bucket_offsets(hist0)
    nb = hist0.shape[1]
    rows["scan_kernel"] = dict(
        ms=ms(lambda x: scan.scan_kernel(x, inclusive=True), u0),
        plain_ms=ms(lambda x: scan.scan_plain(x, inclusive=True), u0, iters=5),
        bytes=8 * n, ops=n,
        library_ms=ms(lambda x: torch.cumsum(x, 0, dtype=torch.int32), u0))
    rows["digit_histogram_kernel"] = dict(
        ms=ms(lambda x: radix.digit_histogram(x, bit=0, tile=rtile), u0),
        plain_ms=ms(lambda x: radix.digit_histogram_plain(x, bit=0, tile=rtile), u0, iters=5),
        bytes=4 * n + 4 * radix.R * nb, ops=2 * n, library_ms=None)
    rows["reorder_kernel"] = dict(
        ms=ms(lambda x: radix.reorder_pass(x, offs0, bit=0, tile=rtile, out=yr), xr),
        plain_ms=ms(lambda x: radix.reorder_pass_plain(x, offs0, bit=0, tile=rtile, out=yr),
                    xr, iters=3),
        bytes=2 * 2 * 4 * n + 4 * radix.R * nb, ops=2 * n, library_ms=None)
    before = _build.SCAN.launches
    radix.bucket_offsets(hist0)
    table_launches = _build.SCAN.launches - before
    table_ms = ms(radix.bucket_offsets, hist0)
    table_plain_ms = ms(lambda h: scan.scan_plain(h.reshape(-1)), hist0)
    print(json.dumps({"calls_of": "scan_kernel", "radix_table_entries": radix.R * nb,
                      "launches_per_table_scan": table_launches, "ms": table_ms,
                      "plain_ms": table_plain_ms,
                      "bound_ms": bound(8 * radix.R * nb, radix.R * nb)[0]}))
    print(json.dumps({"calls_of": "reorder_kernel", "columns": 1,
                      "ms": ms(lambda x: radix.reorder_pass(x, offs0, bit=0, tile=rtile,
                                                            out=yr[:1]), xr[:1]),
                      "bound_ms": bound(2 * 4 * n + 4 * radix.R * nb, 2 * n)[0]}))
    del xr, yr

    kernels = []
    for k in _build.KERNELS:
        r = rows[k.name]
        b_ms, b_by = bound(r["bytes"], r["ops"])
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"tpu_radix_sort_torch/csrc/{k.source}.cu",
            "replaces": REPLACES[k.name],
            "launches": main_counts[k.name],
            "max_abs_err": max_err[k.name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": r["library_ms"],
        })
    sort_bound, _ = bound(2 * n_arr * 4 * HEADLINE_N, 0)
    print(json.dumps({"sort": {
        "n": HEADLINE_N, "tile": tile, "smem_bytes_per_block": n_arr * tile * 4,
        "ms": sort_ms, "keys_only_ms": keys_only_ms,
        "library_ms": lib_ms, "library": "torch.sort(stable=True) on the biased int32 keys",
        "bound_ms": sort_bound, "is_sorted_ms": gate_ms,
        "launches_per_sort": per_case["headline k+v 2^26"],
        "launches_per_keys_only_sort": per_case["keys-only 2^26"],
        "peak_mem_bytes_headline": peak_headline,
        "radix_ms": radix_ms, "radix_keys_only_ms": radix_keys_only_ms,
        "radix_tile": rtile,
        "radix_launches_per_sort": per_case["radix k+v 2^26"],
        "radix_launches_per_keys_only_sort": per_case["radix keys-only 2^26"],
        "radix_engine_bound_ms": 16 * (bound(rows["digit_histogram_kernel"]["bytes"], 0)[0]
                                       + bound(rows["reorder_kernel"]["bytes"], 0)[0]
                                       + bound(8 * radix.R * nb, 0)[0]),
        "radix_early_exit_passes": passes,
        "prefix_sum_ms": prefix_ms, "prefix_sum_bound_ms": bound(8 * n, n)[0],
        "cumsum_ms": rows["scan_kernel"]["library_ms"],
        "peak_mem_bytes_all": torch.cuda.max_memory_allocated(),
        "seconds_total": time.perf_counter() - t_start,
    }}))
    print(json.dumps({"kernels": kernels}))


if __name__ == "__main__":
    sys.exit(main())
