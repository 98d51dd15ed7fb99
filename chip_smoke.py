#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

Run from the root of a checkout on a machine with the card:

    python3 chip_smoke.py

It builds the kernels from ``tpu_radix_sort_torch/csrc`` (nvcc, sm_90a),
holds each kernel against its plain PyTorch version on the card, drives the
public entry points at the headline size (bench.py's 2^26 u32 key + rank
payload) through both sort engines by name (the bitonic network and
``method='radix'``) and through ``'auto'``, held to the launches of the
engine it takes, the mid-sort early exit, ``prefix_sum`` and the other
options, then 64-bit keys (u64 key + rank, keys-only, float64 total order,
the 7-column bitonic and 6-column radix paths, the two-column order-check
gate, ``is_sorted``/``disorder_count``) and bfloat16 keys at 2^26; then,
as a path of its own with its own launch counts, the batched and
segmented sorts at 2^24 (1,024 rows of 16,384, keys-only and with a
per-row iota; S = 4,096 Zipf-sized and S = 1,024 equal segments;
``argsort_segments``) and the 8-column, 4-key-word 64-bit segmented sort
at 2^22; then, as a path of its own with its own launch counts, the
compare-exchange probes of ``tpu_radix_sort_torch/benchmarks`` (P1
``explore_ce`` in every variant, both formulations, 16 and 0 stages, each
beside a ``copy_`` of its columns, and held against its plain version at
one tile, two tiles and 2^24, twice in a row and in place; P2 and
P3 ``explore_blocksort`` on one tile and on 256 (P2 a tile a cluster, P3's
rings split across the lanes of a warp on one tile), one tile also in each
cluster size and each split, beside the launch floor (an empty kernel,
queued as the probes are), ``torch.sort(dim=1)`` and ``sort_batched``; the
scan probes P4-P7 ``explore_scan`` at 2^24: the
copy floor, K4, the chained scan and the two-pass scan with P4 and P5
alone, each beside ``copy_``, ``torch.cumsum`` or a sum; ``explore_keys16``:
the probe's 2^24 u16 sort lines, the two counting sorts with P8's running
max among them, each byte-checked against ``torch.sort``, P8 alone beside
``torch.cummax``, and P9 for four lane types at 16 and 256 stages), each
kernel then held against its plain version byte for byte (the chained
scans P7 and P8 also at the edges of their clusters, the copy P6 at
the edges of its chunks, each case 50 times, P2 at 1, 3 and 256 tiles in
each cluster size, P3 at 1, 2, 3, 33 and 256 tiles, 0, 1, 63 and 64
stages, with every split, and P9 also on every 16-bit
pattern beside the values the lane types disagree on); then, as a path of
its own, the mesh phase (``parallel/``, :func:`mesh_phase`): K1's
merge-tree schedule against its plain version at 2^22, then a world of 4
gloo ranks spawned on the one card (2^26 u32 key + rank and keys-only
through ``sort(mesh=)`` with ``method='auto'`` and ``'exchange'``, their K1
launches a rank against the schedules, ``check_order`` on sorted input,
``prefix_sum``, ``is_sorted`` and ``disorder_count`` at 2^26, u64 key + rank,
``sort_segments`` and ``sort_batched`` at 2^24, the exchange at D = 3, the
layout case at 2^20, ``overlap_chunks=4``, ``dryrun_multichip(4)``) and a
world of 1 NCCL rank (both strategies at 2^20), every rank's shard of each
result held against the single-device sort on the card and the numpy
golden; then, as a path of its own, the runtime and demos phase
(:func:`runtime_phase`): the native CPU sort builds and loads; one 2^26
u32 key + rank sort through each engine under ``runtime.trace`` in an
``annotate("sort")`` span, the trace's kernel events of the port's kernels
equal to the launch counter's, and the card's busy share within the span;
``examples/demo.py`` at 2^26 (``--values --ranks``) and at 2^22
(``--check-order --consecutive 4``, ``--packed``, ``--dtype uint64
--check-order``), ``examples/demo_mesh.py`` with 4 gloo ranks on the card
at 2^22 (``--values --scan``), then ``benchmarks/crossover.py`` and the
probes ``explore_stages``, ``explore_segmented``, ``explore_blockrows``,
``explore_msd`` and ``explore_primitives``, each ``check`` then ``main``;
checks every result byte for byte, times the sorts, the scan,
each kernel, its plain version and ``torch.sort``/``torch.cumsum`` (K1's
replayed calls each the median of several, its tile calls split into
phase 1 and the mean merge tail, the row-local network (the batched
sorts' own two networks among them) and every 4-key or 8-column instance
replayed too; K4 also at a 4-byte offset and 20 times
in a row at 2^26; K2 20 calls back to back; K3 call by call, each after a
write that empties L2 of its input; K6 with 1 to 6 columns, each
beside a device ``copy_`` of the same columns), and prints:

- the card's name and power limit and its maximum SM clock (``nvidia-smi``)
  and the build's register, shared-memory and spill lines (it fails if the
  K1 tile kernel spills with 2 or 3 columns, either K1 kernel with 4 key
  words or 8 columns, the K6 reorder kernel at any digit width, any of P1's 20 kernels,
  any kernel of ``csrc/explore_scan.cu`` or ``csrc/explore_blocksort.cu``,
  or P9's int32 or bfloat16 kernel);
- one line per check, and one JSON line per probe case;
- one JSON line ``{"ce_probe_design": {...}}``: P1's problem shape, threads
  and buffers a block, and for each of its 20 kernels the blocks resident
  an SM, the shared memory a block and the grid (from the C launch) at
  2^24 and on one tile;
- one JSON line ``{"blocksort_probe_design": {...}}``: P2's cluster size
  and grid by tile count and the clusters resident at once, P3's split and
  grid at each of its check tiles on this card, the launch floor (one
  block, one cluster), each one-tile time over it, and the times by
  cluster size and by split;
- one JSON line ``{"scan_probe_design": {...}}``: the chained scans'
  cluster size and the clusters resident at once, P7's and P8's links at
  2^24 and their time a link, and P6 over ``copy_``;
- one JSON line ``{"keys16_stage_design": {...}}``: P9 for each lane type
  at 16 and 256 stages, its time, bound, what sets the bound and the share
  of the bound reached, and each time over int32's;
- one line a case of the mesh phase (each rank's launches, bytes sent and
  received, wall, device time between collectives and collective time;
  four processes share the card: not multi-GPU times) and one JSON line
  ``{"mesh": {...}}``;
- for the runtime and demos phase: each engine's busy share, the demos'
  and crossover's tables, the probes' rows, one JSON line each for
  ``profile``, ``demos``, ``crossover``, ``stages``, ``segmented``,
  ``blockrows``, ``msd`` and ``primitives`` (each with the card's name and
  power limit), and the seconds of each of its steps;
- each phase's seconds, as it ends;
- one JSON line ``{"kernels": [...]}``;
- last, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero. It also exits
non-zero without printing a result where ``torch.cuda.is_available()`` is
false or the package is not beside it. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

HEADLINE_N = 1 << 26
SPLIT_N = 40_000_000
OPTION_N = 1 << 22
SMALL_N = (1 << 16) + 3
CHECK_N = (1 << 24) + 3  # the order-check kernels against their plain versions
SLICE_N = 1 << 24  # the batched and segmented sorts (benchmarks/workloads.py)
REPLAY_REPEATS = 5  # kernel calls timed per replayed call; the median counts
# the engines each option case runs through: both by name, then what 'auto'
# takes at that size (held to the same launches as that engine's run)
ENGINES = ("bitonic", "radix", "auto")
# the K1 instances (columns, key words) that the segmented sorts added
NEW_K1 = ((4, 4), (5, 4), (6, 4), (7, 4), (8, 1), (8, 2), (8, 3), (8, 4))
SEED = 20261016
# The TPU kernel each CUDA kernel replaces (the Pallas kernel function).
REPLACES = {
    "bitonic_tile_kernel": "tpu_radix_sort/ops/bitonic.py:267",
    "bitonic_global_stage_kernel": "tpu_radix_sort/ops/bitonic.py:267",
    "disorder_kernel": "tpu_radix_sort/ops/checksort.py:39",
    "disorder_cols_kernel": "tpu_radix_sort/ops/checksort.py:90",
    "scan_kernel": "tpu_radix_sort/ops/scan.py:71",
    "digit_histogram_kernel": "tpu_radix_sort/ops/radix.py:57",
    "reorder_kernel": "tpu_radix_sort/ops/radix.py:129",
    "explore_ce_kernel": "benchmarks/explore_ce.py:56",
    "blocksort_ce_kernel": "benchmarks/explore_blocksort.py:42",
    "blocksort_stages_kernel": "benchmarks/explore_blocksort.py:74",
    "blocksort_stages_split_kernel": "benchmarks/explore_blocksort.py:74",
    "keys16_stage_kernel": "benchmarks/explore_keys16.py:144",
    "blocksum_kernel": "benchmarks/explore_scan.py:77",
    "addback_kernel": "benchmarks/explore_scan.py:82",
    "grid_copy_kernel": "benchmarks/explore_scan.py:30",
    "chained_scan_kernel": "benchmarks/explore_scan.py:56",
    "cummax_kernel": "benchmarks/explore_keys16.py:45",
}


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)
    print(f"check ok: {what}", flush=True)


def bound(n_bytes, n_ops):
    from tpu_radix_sort_torch.benchmarks import ALU_OPS_PER_S, HBM_BYTES_PER_S

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
    """Byte equality of two tensors of equal element size (any dtype)."""
    import torch

    view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.dtype.itemsize]
    return (a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
            and torch.equal(a.view(view), b.view(view)))


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
        from tpu_radix_sort_torch.ops import bitonic, checksort, common, radix, scan, segmented
        from tpu_radix_sort_torch.runtime.timing import device_time
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"max SM clock: {clock} (the integer rate of the probes' bounds, "
          f"benchmarks/__init__.py ALU_OPS_PER_S, takes 1980 MHz)", flush=True)
    from tpu_radix_sort_torch.benchmarks import SM_CLOCK_HZ, SMS

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    check(clock == f"{SM_CLOCK_HZ / 1e6:.0f} MHz" and sms == SMS,
          f"the card has the {SMS} SMs and the {SM_CLOCK_HZ / 1e6:.0f} MHz maximum SM clock "
          f"that ALU_OPS_PER_S assumes ({sms} SMs, {clock})")
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
    from tpu_radix_sort_torch.benchmarks import (explore_blocksort, explore_ce, explore_keys16,
                                                 explore_scan)
    from tpu_radix_sort_torch.models.golden import golden_prefix_sum, golden_sort
    from tpu_radix_sort_torch.ops import bitonic, checksort, common, radix, scan, segmented
    from tpu_radix_sort_torch.runtime.timing import device_time

    t_start = time.perf_counter()
    phase_seconds = {}
    marks = []

    def phase_mark(name):
        """Close the running phase (its seconds) and open `name`."""
        now = time.perf_counter()
        if marks:
            phase_seconds[marks[-1][0]] = now - marks[-1][1]
            print(f"phase {marks[-1][0]}: {phase_seconds[marks[-1][0]]:.1f} s", flush=True)
        marks.append((name, now))

    # ---- build ------------------------------------------------------------
    phase_mark("build")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    spills = {}
    for name, log in sorted(logs.items()):
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line and entry:
                spills[entry] = int(line.split("bytes spill stores")[0].split(",")[-1])
            elif "Used" in line and entry:
                print(f"ptxas {name}: {entry}: {line.split(':', 1)[1].strip()}, "
                      f"{spills.get(entry, 0)} bytes spill stores")
    tile_spills = {m.groups(): b for e, b in spills.items()
                   if (m := re.search(r"bitonic_tile_kernelILi(\d)ELi(\d)E", e))}
    global_spills = {m.groups(): b for e, b in spills.items()
                     if (m := re.search(r"bitonic_global_stage_kernelILi(\d)ELi(\d)E", e))}
    reorder_spills = {e: b for e, b in spills.items() if "reorder_kernel" in e}
    # P1's kernels: (formulation, kind, columns, key words, column type) ->
    # spill bytes
    ce_spills = {m.groups(): b for e, b in spills.items()
                 if (m := re.search(r"ce_(smem|regs)_kernelILi(\d)ELi(\d)ELi(\d)ELb\dE(\w)", e))}
    # the kernels of csrc/explore_scan.cu: P6, P4, P5, and the chained scan
    # with sum (P7) and with max (P8)
    scan_probe_spills = {m.group(0): b for e, b in spills.items()
                         if (m := re.search(r"(grid_copy|blocksum|addback)_kernel"
                                            r"|chained_scan_kernelINS_6(AddU32|MaxI32)", e))}
    # P9's kernels with 128 registers of row: int32 and bfloat16
    stage_spills = {m.group(0): b for e, b in spills.items()
                    if (m := re.search(r"stage(32|_bf16)_kernel", e))}
    # P2 in clusters of 8 and 16, P3's register kernel and its five splits
    blocksort_spills = {m.group(1) + (m.group(2) or ""): b for e, b in spills.items()
                        if (m := re.search(r"\d(blocksort_(?:ce|stages|stages_split)_kernel)"
                                           r"(?:ILi(\d+)E)?", e))}

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

    def rand_u64(n):
        return torch.randint(-2**63, 2**63 - 1, (n,), dtype=torch.int64, device=dev,
                             generator=gen).view(torch.uint64)

    max_err = {k.name: 0 for k in _build.KERNELS}

    # ---- kernels vs plain versions, small shapes ---------------------------
    phase_mark("kernels vs plain")
    # (3, 3): the 64-bit key + rank sort; (6, 3) and (7, 3): the 64-bit key
    # paths' widest networks
    for n_arr, n_keys in ((1, 1), (2, 2), (3, 2), (3, 3), (4, 2), (6, 3), (7, 3)):
        n, tile = 1 << 16, 1024
        x = torch.stack([rand_u32(n, 1 << 12).view(torch.int32)]
                        + [rand_u32(n).view(torch.int32) for _ in range(n_arr - 1)])
        if n_keys >= 2:
            x[n_keys - 1] = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
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
    n = CHECK_N
    base = rand_u32(n)
    srt = torch.sort(common.bias_i32(base.view(torch.int32)))[0]
    srt = common.bias_i32(srt)
    for label, u in (("sorted", srt), ("reversed", srt.flip(0)),
                     ("random", base.view(torch.int32))):
        got = checksort.disorder_kernel(u)
        want = checksort.disorder_plain(u)
        max_err["disorder_kernel"] = max(max_err["disorder_kernel"], u32_err(got, want))
        check(same(got, want), f"K2 == plain on {label} u32, n {n} "
              f"(count {int(got.view(torch.uint32)[0])})")
    del base, srt

    # K3 on the (hi, lo) view of u64 keys; pair (b - 1, b) straddles two of
    # its 256-thread CUDA blocks
    v = rand_u64(n).view(torch.int64)
    srt = torch.sort(v ^ common.SIGN_I64)[0] ^ common.SIGN_I64
    edge = srt.clone()
    b = 256 * 1000
    edge[b] = edge[b - 1] - 1
    for label, x, want_count in (
            ("sorted", srt, 0), ("reversed", srt.flip(0), None), ("random", v, None),
            ("equal hi, lo deciding", (v & 0xFFFFFFFF) | (0x1BCD1234 << 32), None),
            ("one inversion across a block boundary", edge, 1)):
        hi, lo = common.to_sortable_u64_cols(x)
        got = checksort.disorder_cols_kernel(hi, lo)
        want = checksort.disorder_cols_plain(hi, lo)
        max_err["disorder_cols_kernel"] = max(max_err["disorder_cols_kernel"],
                                              u32_err(got, want))
        check(same(got, want) and want_count in (None, int(got)),
              f"K3 == plain on {label} u64, n {n} (count {int(got.view(torch.uint32)[0])})")
    del v, srt, edge, hi, lo

    table_n = radix.R * common.cdiv(HEADLINE_N, radix.DEFAULT_TILE)
    scan_sizes = (1, scan.SCAN_TILE, scan.SCAN_TILE + 1, SMALL_N, table_n)
    for n in scan_sizes:
        whole = rand_u32(n + 1).view(torch.int32)
        # whole[1:] lies at a 4-byte offset: the kernel's scalar loads
        for label, u in (("aligned", whole[:n]), ("4-byte offset", whole[1:])):
            for inclusive in (False, True):
                before = _build.SCAN.launches
                err = u32_err(scan.scan_kernel(u, inclusive=inclusive),
                              scan.scan_plain(u, inclusive=inclusive))
                max_err["scan_kernel"] = max(max_err["scan_kernel"], err)
                if err or _build.SCAN.launches != before + 1:
                    raise CheckFailed(f"K4 differs from plain or is not one launch, n {n}, "
                                      f"{label}, inclusive {inclusive}")
    check(max_err["scan_kernel"] == 0,
          f"K4 == plain in one launch, exclusive and inclusive, aligned and at a 4-byte "
          f"offset, n in {scan_sizes}")
    # back-to-back repeats at the headline size, each compared: a look-back
    # race would show as a wrong prefix now and then
    u = rand_u32(HEADLINE_N).view(torch.int32)
    want = scan.scan_plain(u)
    outs = [scan.scan_kernel(u) for _ in range(20)]
    errs = [u32_err(o, want) for o in outs]
    max_err["scan_kernel"] = max(max_err["scan_kernel"], *errs)
    check(not any(errs), "K4 == plain on 20 back-to-back exclusive scans of 2^26")
    del u, want, outs
    # K6's chunk is 4,096 elements: tiles below it (one warp at 2 bits) and
    # above it; all-equal keys fill a tile of 2^16 with one digit run. Every
    # digit width: 2 (check_order), 4 and 6 (last digits), 8
    radix_tiles = (32, 128, radix.DEFAULT_TILE, 1 << 15, 1 << 16)
    for n_arr in (1, 2, 3, 4, 5, 6):  # 5 and 6: the 64-bit radix paths
        x = torch.stack([rand_u32(SMALL_N).view(torch.int32) for _ in range(n_arr)])
        for keys_kind in ("random", "all-equal"):
            if keys_kind == "all-equal":
                x[0] = common.i32(0xDEADBEEF)
            for w in radix.DIGIT_BITS:
                for bit in (0, 2, 16, 32 - w):
                    for tile in radix_tiles:
                        hist = radix.digit_histogram(x[0], bit=bit, tile=tile, digit_bits=w)
                        err_h = u32_err(hist, radix.digit_histogram_plain(
                            x[0], bit=bit, tile=tile, digit_bits=w))
                        offs = radix.bucket_offsets(hist)
                        got = radix.reorder_pass(x, offs, bit=bit, tile=tile, digit_bits=w)
                        want = radix.reorder_pass_plain(x, offs, bit=bit, tile=tile,
                                                        out=torch.empty_like(x), digit_bits=w)
                        err_r = u32_err(got, want)
                        max_err["digit_histogram_kernel"] = max(
                            max_err["digit_histogram_kernel"], err_h)
                        max_err["reorder_kernel"] = max(max_err["reorder_kernel"], err_r)
                        if err_h or err_r:
                            raise CheckFailed(f"K5/K6 differ from plain: {n_arr} columns, "
                                              f"{keys_kind} keys, {w}-bit digit at bit {bit}, "
                                              f"tile {tile}")
        check(True, f"K5 and K6 == plain, {n_arr} columns, n 2^16+3, random and all-equal "
              f"keys, digits of {radix.DIGIT_BITS} bits at bits 0/2/16/top, tiles {radix_tiles}")
    del x, got, want

    # ---- the main path -----------------------------------------------------
    phase_mark("main path")
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
                   lambda: trt.sort(keys, iota, values_are_ranks=True, method="bitonic"))
    rk, rv = torch_ref(keys)
    check(same(ok, rk) and same(ov, rv),
          "sort(keys, iota, values_are_ranks=True, method='bitonic'), 2^26 u32 == "
          "torch.sort(stable=True)")
    peak_headline = torch.cuda.max_memory_allocated()
    ko = drive("keys-only 2^26", lambda: trt.sort(keys, method="bitonic"))
    check(same(ko, rk), "keys-only sort, method='bitonic', 2^26 u32 == torch.sort")
    del ko
    # 'auto' at the headline size: the radix engine, 4 passes of 8 bits
    wide0 = radix.pass_counts()
    aok, aov = drive("auto k+v 2^26", lambda: trt.sort(keys, iota, values_are_ranks=True))
    d = per_case["auto k+v 2^26"]
    wide1 = radix.pass_counts()
    check(same(aok, rk) and same(aov, rv) and d["digit_histogram_kernel"] == 4
          and d["scan_kernel"] == 4 and d["reorder_kernel"] == 4
          and d["bitonic_tile_kernel"] == 0 and d["bitonic_global_stage_kernel"] == 0
          and {w: wide1[w] - wide0[w] for w in wide1} == {2: 0, 4: 0, 6: 0, 8: 4},
          "sort(keys, iota, values_are_ranks=True), 2^26 u32: 'auto' takes the radix engine "
          "(4 K5, 4 K4, 4 K6 at 8 bits a digit, no K1) == torch.sort(stable=True)")
    del aok, aov

    def auto_took(fmt, engine):
        """The case `fmt` with 'auto' launched what it did with `engine`."""
        a, e = per_case[fmt.format("auto")], per_case[fmt.format(engine)]
        check(a == e, f"{fmt.format('auto')}: 'auto' takes {engine!r} (the same launches)")

    sk = rand_u32(SPLIT_N, 1 << 20)
    sv = torch.arange(SPLIT_N, dtype=torch.int32, device=dev).view(torch.uint32)
    sok, sov = drive("split k+v 40M", lambda: trt.sort(sk, sv, values_are_ranks=True,
                                                       method="bitonic"))
    gk, gv = golden_sort(sk.cpu().numpy(), sv.cpu().numpy())
    check(np.array_equal(sok.cpu().numpy(), gk) and np.array_equal(sov.cpu().numpy(), gv),
          "sort of n = 40,000,000 (split path: prefix + remainder + merge) == golden")
    del sk, sv, sok, sov, gk, gv

    cok, cov = drive("check_order sorted 2^26", lambda: trt.sort(
        ok, ov, values_are_ranks=True, check_order=True, method="bitonic"))
    d = per_case["check_order sorted 2^26"]
    check(same(cok, ok) and same(cov, ov) and d["disorder_kernel"] == 2
          and d["bitonic_tile_kernel"] == 0 and d["bitonic_global_stage_kernel"] == 0,
          "check_order=True on sorted input: K2 gates, K1 does not run")
    del cok, cov
    small = keys[:OPTION_N]
    uok = drive("check_order unsorted 2^22",
                lambda: trt.sort(small, check_order=True, method="bitonic"))
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
    for method in ENGINES:
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
    for label, *_ in cases:
        auto_took(f"{label} {{}} 2^22", "bitonic")  # under 3 * 2^21 u32 keys

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

    # 64-bit keys at the headline size (ops/sort64.py): half of the keys
    # share one hi word, so lo decides there
    def ref64(k):
        sk, idx = torch.sort(k.view(torch.int64) ^ common.SIGN_I64, stable=True)
        return (sk ^ common.SIGN_I64).view(torch.uint64), idx.to(torch.int32).view(torch.uint32)

    k64 = rand_u64(HEADLINE_N)
    k64v = k64.view(torch.int64)
    k64v[: HEADLINE_N // 2] = (k64v[: HEADLINE_N // 2] & 0xFFFFFFFF) | (0x1BCD1234 << 32)
    r64k, r64v = ref64(k64)
    for method in ENGINES:
        o = drive(f"u64 k+rank {method} 2^26",
                  lambda: trt.sort(k64, iota, values_are_ranks=True, method=method))
        check(same(o[0], r64k) and same(o[1], r64v),
              f"sort(u64 keys, iota, values_are_ranks=True, method={method!r}), 2^26 "
              f"== torch.sort(stable=True) of the biased int64 view")
        o = drive(f"u64 keys-only {method} 2^26", lambda: trt.sort(k64, method=method))
        check(same(o, r64k), f"sort(u64 keys, method={method!r}), 2^26 == torch.sort")
    check(per_case["u64 keys-only radix 2^26"]["digit_histogram_kernel"] == 8,
          "the 64-bit radix sort runs 8 passes")
    auto_took("u64 k+rank {} 2^26", "radix")
    auto_took("u64 keys-only {} 2^26", "radix")
    f64 = torch.randn(HEADLINE_N, dtype=torch.float64, device=dev, generator=gen) * 1e6
    f64[::1000] = float("inf")
    f64[7::1000] = -float("inf")
    rf64 = torch.sort(f64, stable=True)[0]
    for method in ENGINES:
        o = drive(f"f64 total_order {method} 2^26",
                  lambda: trt.sort(f64, total_order=True, method=method))
        check(same(o, rf64), f"sort(f64, total_order=True, method={method!r}), 2^26 "
              "== torch.sort of the floats")
    auto_took("f64 total_order {} 2^26", "radix")
    del f64, rf64, o
    wk, wv = k64[:OPTION_N], rand_u64(OPTION_N)
    gk, gv = golden_sort(wk.cpu().numpy(), wv.cpu().numpy(), bit_count=40)
    for method in ENGINES:
        o = drive(f"u64 bit_count=40 u64 values {method} 2^22",
                  lambda: trt.sort(wk, wv, bit_count=40, method=method))
        check(np.array_equal(o[0].cpu().numpy(), gk) and np.array_equal(o[1].cpu().numpy(), gv),
              f"sort(u64 keys, u64 values, bit_count=40, method={method!r}), 2^22 == golden "
              "(7 columns through K1, 6 through K6)")
    auto_took("u64 bit_count=40 u64 values {} 2^22", "bitonic")  # under 3 * 2^21 u64 keys
    for method in ENGINES:
        case = f"u64 check_order sorted {method} 2^26"
        o = drive(case, lambda: trt.sort(r64k, check_order=True, method=method))
        d = per_case[case]
        check(same(o, r64k) and d["disorder_cols_kernel"] == 2 and d["disorder_kernel"] == 0
              and all(d[k] == 0 for k in ("bitonic_tile_kernel", "bitonic_global_stage_kernel",
                                          "digit_histogram_kernel", "reorder_kernel")),
              f"u64 check_order=True on sorted input, method={method!r}: K3 gates, "
              "K1/K5/K6 do not run")
    auto_took("u64 check_order sorted {} 2^26", "radix")
    _, lo_idx = torch.sort(k64v & 0xFFFFFFFF, stable=True)
    for method in ENGINES:
        # one key column (lo,), the full key carried as (hi, lo)
        lo_sorted = drive(f"u64 bit_count=32 {method} 2^26",
                          lambda: trt.sort(k64, bit_count=32, method=method))
        check(same(lo_sorted, k64v[lo_idx]),
              f"sort(u64 keys, bit_count=32, method={method!r}), 2^26 == torch.sort of lo")
    d = per_case["u64 bit_count=32 bitonic 2^26"]
    check(d["bitonic_tile_kernel"] >= 1 and d["digit_histogram_kernel"] == 0,
          "u64 bit_count=32, method='bitonic': K1 sorts the one key column")
    check(per_case["u64 bit_count=32 radix 2^26"]["digit_histogram_kernel"] == 4,
          "u64 bit_count=32, method='radix': 4 passes over the one key column")
    auto_took("u64 bit_count=32 {} 2^26", "radix")
    case = "u64 check_order sorted bit_count=32 2^26"
    o = drive(case, lambda: trt.sort(lo_sorted, bit_count=32, check_order=True))
    d = per_case[case]
    check(same(o, lo_sorted) and d["disorder_kernel"] == 2 and d["disorder_cols_kernel"] == 0
          and d["bitonic_tile_kernel"] == 0,
          "u64 check_order=True with bit_count=32 on sorted input: K2 gates, K3 does not run")
    del lo_idx, lo_sorted, o
    o = drive("u64 is_sorted 2^26", lambda: (trt.is_sorted(r64k), trt.is_sorted(k64)))
    check(o == (True, False) and per_case["u64 is_sorted 2^26"]["disorder_cols_kernel"] == 3,
          "is_sorted of sorted and unsorted u64, 2^26 (K3: 2 + 1 launches)")
    o = drive("u64 disorder_count 2^26", lambda: trt.disorder_count(k64))
    want = checksort.disorder_cols_plain(*common.to_sortable_u64_cols(k64))
    check(o.dtype == torch.uint32 and int(o) == int(want),
          f"disorder_count of u64, 2^26 == plain ({int(o)})")

    # bfloat16 keys at the headline size: their u16 pattern in a u32 lane
    b16 = torch.randint(-2**15, 2**15, (HEADLINE_N,), dtype=torch.int16, device=dev,
                        generator=gen).view(torch.bfloat16)
    _, idx16 = torch.sort(b16.view(torch.int16).to(torch.int32) & 0xFFFF, stable=True)
    rb_k, rb_v = b16[idx16], idx16.to(torch.int32).view(torch.uint32)
    del idx16
    for method in ENGINES:
        o = drive(f"bf16 keys-only {method} 2^26", lambda: trt.sort(b16, method=method))
        check(same(o, rb_k), f"sort(bf16 keys, method={method!r}), 2^26 == torch.sort of "
              "the u16 patterns")
        o = drive(f"bf16 k+iota {method} 2^26",
                  lambda: trt.sort(b16, iota, values_are_ranks=True, method=method))
        check(same(o[0], rb_k) and same(o[1], rb_v),
              f"sort(bf16 keys, iota, method={method!r}), 2^26 == torch.sort(stable=True)")
    check(per_case["bf16 keys-only radix 2^26"]["digit_histogram_kernel"] == 2,
          "the 16-bit radix sort runs 2 passes")
    auto_took("bf16 keys-only {} 2^26", "radix")
    auto_took("bf16 k+iota {} 2^26", "radix")
    u16 = (small.cpu().numpy() >> np.uint32(16)).astype(np.uint16)
    for method in ENGINES:
        o = drive(f"u16 count < n bit_count=12 {method} 2^22", lambda: trt.sort(
            u16, hv, count=cnt, bit_count=12, descending=True, method=method))
        want = golden_sort(u16, hv, count=cnt, bit_count=12, descending=True)
        check(all(np.array_equal(a.cpu().numpy(), w) for a, w in zip(o, want)),
              f"sort(u16 keys, count < n, bit_count=12, descending, method={method!r}), "
              "2^22 == golden")
    auto_took("u16 count < n bit_count=12 {} 2^22", "radix")
    del o, u16

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
    for k in _build.SORT_KERNELS:
        check(main_counts[k.name] > 0, f"{k.name} launched on the main path "
              f"({main_counts[k.name]})")
    del small

    # ---- the batched and segmented sorts: this path's own counts ----------
    phase_mark("batched and segmented")
    # benchmarks/workloads.py:236-259: 2^24 u32 keys as 1,024 rows of
    # 16,384 (batched), as S = 4,096 segments of Zipf sizes (a seeded
    # multinomial, every segment >= 1) and as S = 1,024 equal segments
    torch.cuda.synchronize()
    _build.reset_launches()
    n_rows, row = 1024, SLICE_N // 1024
    kb = rand_u32(SLICE_N).view(n_rows, row)
    row_ranks = torch.arange(row, dtype=torch.int32, device=dev).expand(n_rows, row)
    row_ranks = row_ranks.contiguous().view(torch.uint32)

    def rows_ref(k):
        sk, idx = torch.sort(common.bias_i32(k.view(torch.int32)), dim=1, stable=True)
        return common.bias_i32(sk).view(torch.uint32), idx.to(torch.int32).view(torch.uint32)

    rbk, rbv = rows_ref(kb)
    o = drive("batched keys-only 1024x16384", lambda: trt.sort_batched(kb))
    check(same(o, rbk), "sort_batched(1,024 x 16,384 u32) == torch.sort(dim=1)")
    o = drive("batched k+iota 1024x16384",
              lambda: trt.sort_batched(kb, row_ranks, values_are_ranks=True))
    check(same(o[0], rbk) and same(o[1], rbv),
          "sort_batched(1,024 x 16,384 u32, per-row iota, values_are_ranks=True) == "
          "torch.sort(dim=1, stable=True)")

    nrng = np.random.default_rng(SEED)

    def zipf_offsets(n, segs):
        w = nrng.zipf(1.3, segs).astype(np.float64)
        sizes = nrng.multinomial(n - segs, w / w.sum()).astype(np.int64) + 1
        return torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])).to(dev)

    def seg_word(k_lo, offs, key_bits=32):
        """int64 (segment << key_bits) | key: its stable sort is the
        segmented sort's order."""
        seg = torch.repeat_interleave(torch.arange(offs.numel() - 1, device=dev), offs.diff())
        return (seg << key_bits) | k_lo, offs[seg]

    ks = kb.reshape(-1)
    zipf = zipf_offsets(SLICE_N, 4096)
    equal = torch.arange(1025, dtype=torch.int64, device=dev) * row
    z_word, z_start = seg_word(ks.view(torch.int32).to(torch.int64) & 0xFFFFFFFF, zipf)
    zw_sorted, z_idx = torch.sort(z_word, stable=True)
    o = drive("segmented S=4096 Zipf keys-only 2^24", lambda: trt.sort_segments(ks, zipf))
    check(same(o, zw_sorted.to(torch.int32).view(torch.uint32)),
          "sort_segments(2^24 u32, S = 4,096 Zipf sizes) == torch.sort of (segment, key)")
    o = drive("segmented S=1024 equal keys-only 2^24", lambda: trt.sort_segments(ks, equal))
    check(same(o, rbk.reshape(-1)),
          "sort_segments(2^24 u32, S = 1,024 equal) == the batched rows' torch.sort")
    o = drive("argsort_segments S=4096 Zipf 2^24", lambda: trt.argsort_segments(ks, zipf))
    check(same(o.view(torch.int32), (z_idx - z_start).to(torch.int32)),
          "argsort_segments(2^24 u32, S = 4,096 Zipf) == torch.sort's order minus the starts")
    del zw_sorted, z_idx, z_start
    # 64-bit keys, bit_count 40, u64 values: (segment, hi, lo, tie), the full
    # key's hi and lo, the value's hi and lo: 8 columns, 4 key words
    k64s, v64s = rand_u64(OPTION_N), rand_u64(OPTION_N)
    zipf64 = zipf_offsets(OPTION_N, 1024)
    w64, _ = seg_word(k64s.view(torch.int64) & ((1 << 40) - 1), zipf64, key_bits=40)
    i64 = torch.sort(w64, stable=True)[1]
    o = drive("segmented u64 bit_count=40 u64 values 2^22",
              lambda: trt.sort_segments(k64s, zipf64, v64s, bit_count=40))
    check(same(o[0], k64s.view(torch.int64)[i64]) and same(o[1], v64s.view(torch.int64)[i64]),
          "sort_segments(2^22 u64 keys, u64 values, bit_count=40, S = 1,024 Zipf) == "
          "torch.sort of (segment, low 40 bits)")
    del i64
    slice_counts = _build.launch_counts()
    print(f"launches batched and segmented path: {json.dumps(slice_counts)}", flush=True)
    for case, d in per_case.items():
        if case.startswith(("batched", "segmented", "argsort_segments")):
            seg = not case.startswith("batched")
            check(d["bitonic_tile_kernel"] > 0
                  and (not seg or d["bitonic_global_stage_kernel"] > 0 and d["scan_kernel"] > 0),
                  f"{case}: K1 launched{' (tile and global) and K4' if seg else ''} "
                  f"({d['bitonic_tile_kernel']}, {d['bitonic_global_stage_kernel']}, "
                  f"{d['scan_kernel']})")

    # ---- times ------------------------------------------------------------
    phase_mark("times")
    sort_ms = device_time(lambda k, v: trt.sort(k, v, values_are_ranks=True, method="bitonic"),
                          keys, iota, warmup=2, iters=10) * 1e3
    keys_only_ms = device_time(lambda k: trt.sort(k, method="bitonic"),
                               keys, warmup=2, iters=10) * 1e3
    auto_ms = device_time(lambda k, v: trt.sort(k, v, values_are_ranks=True),
                          keys, iota, warmup=2, iters=10) * 1e3
    lib_ms = device_time(
        lambda k: torch.sort(common.bias_i32(k.view(torch.int32)), stable=True),
        keys, warmup=2, iters=10) * 1e3
    gate_ms = device_time(trt.is_sorted, ok, warmup=2, iters=10) * 1e3
    radix_ms = device_time(lambda k, v: trt.sort(k, v, method="radix"),
                           keys, iota, warmup=2, iters=10) * 1e3
    radix_keys_only_ms = device_time(lambda k: trt.sort(k, method="radix"),
                                     keys, warmup=2, iters=10) * 1e3
    prefix_ms = device_time(trt.prefix_sum, pu, warmup=2, iters=10) * 1e3

    def t_ms(fn, *args):
        return device_time(fn, *args, warmup=2, iters=10) * 1e3

    # 64-bit and bfloat16 sorts against torch.sort of the same keys; the
    # bounds: read the inputs and write the outputs once, and for the radix
    # engine its passes (K5 reads the key column, K6 reads and writes every
    # column; 3 columns for 64-bit key+value, 2 keys-only; 1 and 2 for 16-bit)
    nh = HEADLINE_N
    w16 = b16.view(torch.int16).to(torch.int32) & 0xFFFF
    wide = {
        "n": nh,
        "ms": t_ms(lambda k, v: trt.sort(k, v, values_are_ranks=True, method="bitonic"),
                   k64, iota),
        "keys_only_ms": t_ms(lambda k: trt.sort(k, method="bitonic"), k64),
        "radix_ms": t_ms(lambda k, v: trt.sort(k, v, method="radix"), k64, iota),
        "radix_keys_only_ms": t_ms(lambda k: trt.sort(k, method="radix"), k64),
        "library_ms": t_ms(lambda k: torch.sort(k.view(torch.int64) ^ common.SIGN_I64,
                                                stable=True), k64),
        "library": "torch.sort(stable=True) on the biased int64 keys",
        "is_sorted_ms": t_ms(trt.is_sorted, r64k),
        "bound_ms": bound(2 * 12 * nh, 0)[0],
        "keys_only_bound_ms": bound(2 * 8 * nh, 0)[0],
        "radix_engine_bound_ms": 32 * (bound(4 * nh, 0)[0] + bound(2 * 3 * 4 * nh, 0)[0]),
        "radix_keys_only_engine_bound_ms": 32 * (bound(4 * nh, 0)[0]
                                                 + bound(2 * 2 * 4 * nh, 0)[0]),
        "launches_per_sort": per_case["u64 k+rank bitonic 2^26"],
        "launches_per_keys_only_sort": per_case["u64 keys-only bitonic 2^26"],
        "radix_launches_per_sort": per_case["u64 k+rank radix 2^26"],
        "launches_per_gate": per_case["u64 check_order sorted bitonic 2^26"],
    }
    keys16 = {
        "n": nh, "dtype": "bfloat16",
        "ms": t_ms(lambda k, v: trt.sort(k, v, values_are_ranks=True, method="bitonic"),
                   b16, iota),
        "keys_only_ms": t_ms(lambda k: trt.sort(k, method="bitonic"), b16),
        "radix_ms": t_ms(lambda k, v: trt.sort(k, v, method="radix"), b16, iota),
        "radix_keys_only_ms": t_ms(lambda k: trt.sort(k, method="radix"), b16),
        "library_ms": t_ms(lambda w: torch.sort(w, stable=True), w16),
        "library": "torch.sort(stable=True) on the u16 patterns widened to int32",
        "bound_ms": bound(2 * 6 * nh, 0)[0],
        "keys_only_bound_ms": bound(2 * 2 * nh, 0)[0],
        "radix_engine_bound_ms": 8 * (bound(4 * nh, 0)[0] + bound(2 * 2 * 4 * nh, 0)[0]),
        "radix_keys_only_engine_bound_ms": 8 * (bound(4 * nh, 0)[0] + bound(2 * 4 * nh, 0)[0]),
        "launches_per_sort": per_case["bf16 k+iota bitonic 2^26"],
        "launches_per_keys_only_sort": per_case["bf16 keys-only bitonic 2^26"],
        "radix_launches_per_sort": per_case["bf16 k+iota radix 2^26"],
    }
    del w16

    # the batched and segmented sorts against one torch.sort of the same
    # keys (the row-wise sort, or the (segment, key) int64 word); bounds:
    # read the keys (and values) once, write them once
    e_word, _ = seg_word(ks.view(torch.int32).to(torch.int64) & 0xFFFFFFFF, equal)
    words = {"zipf": z_word, "equal": e_word, "u64": w64}
    rows_bias = common.bias_i32(kb.view(torch.int32))
    slice_rows = []
    for label, fn, args, lib, lib_args, n_bytes in (
            ("batched keys-only 1024x16384", trt.sort_batched, (kb,),
             lambda w: torch.sort(w, dim=1, stable=True), (rows_bias,), 8 * SLICE_N),
            ("batched k+iota 1024x16384",
             lambda k, v: trt.sort_batched(k, v, values_are_ranks=True), (kb, row_ranks),
             lambda w: torch.sort(w, dim=1, stable=True), (rows_bias,), 16 * SLICE_N),
            ("segmented S=4096 Zipf keys-only 2^24", trt.sort_segments, (ks, zipf),
             lambda w: torch.sort(w, stable=True), (words["zipf"],), 8 * SLICE_N),
            ("segmented S=1024 equal keys-only 2^24", trt.sort_segments, (ks, equal),
             lambda w: torch.sort(w, stable=True), (words["equal"],), 8 * SLICE_N),
            ("argsort_segments S=4096 Zipf 2^24", trt.argsort_segments, (ks, zipf),
             lambda w: torch.sort(w, stable=True), (words["zipf"],), 8 * SLICE_N),
            ("segmented u64 bit_count=40 u64 values 2^22",
             lambda k, o_, v: trt.sort_segments(k, o_, v, bit_count=40), (k64s, zipf64, v64s),
             lambda w: torch.sort(w, stable=True), (words["u64"],), 32 * OPTION_N)):
        slice_rows.append({"phase": label, "ms": t_ms(fn, *args),
                           "torch_sort_ms": t_ms(lib, *lib_args),
                           "bound_ms": bound(n_bytes, 0)[0], "launches": {
                               k: per_case[label][k] for k in
                               ("bitonic_tile_kernel", "bitonic_global_stage_kernel",
                                "scan_kernel")}})
        print(json.dumps(slice_rows[-1]), flush=True)
    del words, rows_bias, w64, e_word

    # Replay a sort's network call by call, each call on the same input
    # through the kernel (REPLAY_REPEATS times, each on a fresh copy; its
    # time is the median) and the plain version (once). The least bytes a
    # call must move on this data: every key column read once, and for each
    # element the call moves, its other columns read and all its columns
    # written (an element left in place needs no write).
    kind_name = {"tile": "bitonic_tile_kernel", "global": "bitonic_global_stage_kernel"}

    def replay_network(x, n_keys, label, calls=None, tile=None):
        """`calls` defaults to the full sort's schedule at the largest tile;
        the row-local network passes its own."""
        n_arr, n = x.shape
        if calls is None:
            tile = bitonic.resolve_tile(n, n_arr)
            calls = bitonic.sort_schedule(n, tile)
        acc = {name: {"k": [], "p": [], "bytes": 0, "ops": 0} for name in kind_name.values()}
        for call in calls:
            name = kind_name[call[0]]
            a = acc[name]
            stages = call[1] if call[0] == "tile" else [call[1:]]
            want = timed(lambda: bitonic.stages_plain(x.clone(), stages, n_keys), a["p"])
            reps = []
            for _ in range(REPLAY_REPEATS):
                got = x.clone()
                timed(lambda: bitonic.run_schedule(got, [call], n_keys=n_keys, tile=tile), reps)
            a["k"].append(reps)
            err = u32_err(got, want)
            max_err[name] = max(max_err[name], err)
            if err:
                raise CheckFailed(f"K1 {call} differs from plain on the {label} network")
            moved = int((got != x).any(dim=0).sum())
            a["bytes"] += n_keys * 4 * n + moved * (n_arr - n_keys) * 4 + moved * n_arr * 4
            a["ops"] += len(stages) * (n // 2) * n_keys
            x = got
            del want
        for name, a in acc.items():
            if not a["k"]:
                continue
            a["ms"] = [float(np.median(elapsed_ms(r))) for r in a["k"]]
            a["plain_ms"] = elapsed_ms(a["p"])
            calls = len(a["ms"])
            line = {"calls_of": name, "network": label, "columns": n_arr,
                    "n_keys": n_keys, "n": n, "tile": tile, "calls": calls,
                    "repeats": REPLAY_REPEATS,
                    "ms_sum": sum(a["ms"]), "ms_min": min(a["ms"]),
                    "ms_max": max(a["ms"]), "plain_ms_sum": sum(a["plain_ms"]),
                    "bound_ms_sum": bound(a["bytes"], a["ops"])[0],
                    "ms_each": a["ms"] if calls <= 4 else None}
            if name == "bitonic_tile_kernel":  # the schedule's first call is phase 1
                line["phase1_ms"] = a["ms"][0]
                line["merge_tail_mean_ms"] = (sum(a["ms"][1:]) / (calls - 1)
                                              if calls > 1 else None)
            print(json.dumps(line))
        return x, acc, tile

    n_arr, n_keys = 2, 2
    x, acc, tile = replay_network(torch.stack([keys.view(torch.int32), iota.view(torch.int32)]),
                                  n_keys, "u32 key+rank 2^26")
    check(same(x[0], rk) and same(x[1], rv),
          f"K1 == plain per call on the headline network (2^26, 2 columns, tile {tile})")
    rows = {}
    for name, a in acc.items():
        calls = len(a["ms"])
        rows[name] = dict(ms=sum(a["ms"]) / calls, plain_ms=sum(a["plain_ms"]) / calls,
                          bytes=a["bytes"] / calls, ops=a["ops"] / calls, library_ms=None)
    # the 64-bit key + rank network: (hi, lo, rank), n_keys 3
    x, _, t3 = replay_network(torch.stack([*common.to_sortable_u64_cols(k64),
                                           iota.view(torch.int32)]), 3, "u64 key+rank 2^26")
    check(same(common.from_sortable_u64_cols(x[0], x[1], torch.uint64), r64k) and same(x[2], r64v),
          f"K1 == plain per call on the u64 key+rank network (2^26, 3 columns, tile {t3})")
    # the widest network: bit_count 40 with u64 values, 7 columns at 2^22
    u_hi, u_lo = common.to_sortable_u64_cols(wk)
    m_hi, m_lo = map(common.i32, common.bit_mask_cols(40))
    x, _, t7 = replay_network(torch.stack([
        u_hi & m_hi, u_lo & m_lo, torch.arange(OPTION_N, dtype=torch.int32, device=dev),
        u_hi, u_lo, *common.values_to_u32_cols(wv)]), 3, "u64 bit_count=40 u64 values 2^22")
    check(np.array_equal(common.from_sortable_u64_cols(x[3], x[4], torch.uint64).cpu().numpy(), gk)
          and np.array_equal(common.values_from_u32_cols((x[5], x[6]), torch.uint64)
                             .cpu().numpy(), gv),
          f"K1 == plain per call on the 7-column network (2^22, n_keys 3, tile {t7}) == golden")
    del x, wk, wv, gk, gv, u_hi, u_lo
    # the batched path's own row-local networks on its own inputs, 1,024
    # rows of 16,384: keys-only (1 column, 1 key word) and key + per-row
    # rank (2 columns, the rank the tie)
    for cols, label in (((kb,), "keys-only"), ((kb, row_ranks), "k+iota")):
        t, padded = bitonic.rows_layout(n_rows, row, len(cols))
        check(padded == n_rows, f"the batched {label} network needs no sentinel rows")
        x, _, _ = replay_network(torch.stack([c.view(torch.int32).reshape(-1) for c in cols]),
                                 len(cols), f"batched {label} {n_rows} x {row}",
                                 calls=bitonic.row_schedule(row, t), tile=t)
        check(same(x[0].view(n_rows, row).view(torch.uint32), rbk)
              and (len(cols) == 1 or same(x[1].view(n_rows, row).view(torch.uint32), rbv)),
              f"K1 == plain per call on the batched {label} network, {n_rows} rows of {row} "
              f"({len(cols)} columns, tile {t}) == torch.sort(dim=1, stable=True)")
        del x
    del rbk, rbv
    # the row-local network (key + global iota), call by call: rows shorter
    # than the kernel's chunk, one chunk, one tile, and longer than the
    # tile (global calls, the final round from stride row_len/2)
    for row_len in (128, 1024, 16384, 65536):
        for batch in (3, 1000):
            t, padded = bitonic.rows_layout(batch, row_len, 2)
            xr = torch.stack([rand_u32(padded * row_len, 1 << 12).view(torch.int32),
                              torch.arange(padded * row_len, dtype=torch.int32, device=dev)])
            wk, wi = rows_ref(xr[0].view(padded, row_len).view(torch.uint32))
            wi = wi.view(torch.int32) + torch.arange(0, padded * row_len, row_len, device=dev,
                                                     dtype=torch.int32)[:, None]
            x, _, _ = replay_network(xr, 2, f"row-local {batch} x {row_len}",
                                     calls=bitonic.row_schedule(row_len, t), tile=t)
            check(same(x[0].view(padded, row_len).view(torch.uint32), wk)
                  and same(x[1], wi.reshape(-1)),
                  f"K1 == plain per call on the row-local network, {batch} rows of {row_len} "
                  f"(padded to {padded}, tile {t}) == torch.sort(dim=1, stable=True)")
            del xr, x, wk, wi
    # the S = 4,096 segmented sort's network, (segment, key) at 2^24
    seg_ids, _ = segmented.segment_ids_and_starts(zipf, SLICE_N, need_starts=False)
    x, _, tz = replay_network(torch.stack([seg_ids, ks.view(torch.int32)]), 2,
                              "segmented (segment, key) S=4096 2^24")
    check(same(x[1], torch.sort(z_word)[0].to(torch.int32)),
          f"K1 == plain per call on the S = 4,096 segmented network (2^24, 2 key words, "
          f"tile {tz}) == torch.sort of (segment, key)")
    del seg_ids, z_word, x
    # the instances that 4 key words and 8 columns added, at 2^22: a
    # low-entropy leading word, a unique last key word
    for n_arr, n_keys in NEW_K1:
        xw = torch.stack([rand_u32(OPTION_N, 16).view(torch.int32)]
                         + [rand_u32(OPTION_N, 4 if c < n_keys - 1 else None).view(torch.int32)
                            for c in range(1, n_arr)])
        if n_keys > 1:
            xw[n_keys - 1] = torch.randperm(OPTION_N, device=dev, generator=gen).to(torch.int32)
        x, _, tw = replay_network(xw, n_keys, f"{n_arr} columns, {n_keys} key words, 2^22")
        check(not bool(bitonic._lex_lt(x[:n_keys, 1:], x[:n_keys, :-1]).any()),
              f"K1 == plain per call and sorted, {n_arr} columns, {n_keys} key words, "
              f"2^22, tile {tw}")
        del xw, x
    u = ok.view(torch.int32)
    f_ = checksort.FAST_CHECK_ELEMENTS
    a = {"k": [], "p": [], "bytes": 0, "ops": 0}
    for part in (u[:f_], u[f_ - 1:]):
        got = timed(lambda: checksort.disorder_kernel(part), a["k"])
        want = timed(lambda: checksort.disorder_plain(part), a["p"])
        max_err["disorder_kernel"] = max(max_err["disorder_kernel"], u32_err(got, want))
        a["bytes"] += 4 * part.numel() + 4
        a["ops"] += part.numel() - 1
    check(max_err["disorder_kernel"] == 0, "K2 == plain on the gate's two calls at 2^26")
    k_ms, p_ms = elapsed_ms(a["k"]), elapsed_ms(a["p"])
    print(json.dumps({"calls_of": "disorder_kernel", "calls": 2, "ms_each": k_ms,
                      "plain_ms_sum": sum(p_ms), "bound_ms_sum": bound(a["bytes"], a["ops"])[0]}))

    # Replay the headline radix sort (key, iota) pass by pass, each kernel
    # call on the same input as its plain version: the engine's widths and
    # tiles
    wbits = radix.WIDE_BITS
    rtile = radix.default_tile(HEADLINE_N, wbits)
    xr = torch.stack([keys.view(torch.int32), iota.view(torch.int32)])
    yr = torch.empty_like(xr)
    bit = 0
    for w in radix.digit_widths(32):
        t = radix.default_tile(HEADLINE_N, w)
        hist = radix.digit_histogram(xr[0], bit=bit, tile=t, digit_bits=w)
        max_err["digit_histogram_kernel"] = max(
            max_err["digit_histogram_kernel"],
            u32_err(hist, radix.digit_histogram_plain(xr[0], bit=bit, tile=t, digit_bits=w)))
        offs = radix.bucket_offsets(hist)
        max_err["scan_kernel"] = max(max_err["scan_kernel"], u32_err(
            offs.reshape(-1), scan.scan_plain(hist.reshape(-1))))
        radix.reorder_pass(xr, offs, bit=bit, tile=t, out=yr, digit_bits=w)
        want = radix.reorder_pass_plain(xr, offs, bit=bit, tile=t, out=torch.empty_like(xr),
                                        digit_bits=w)
        max_err["reorder_kernel"] = max(max_err["reorder_kernel"], u32_err(yr, want))
        xr, yr = yr, xr
        bit += w
        del want
    check(max_err["digit_histogram_kernel"] == 0 and max_err["reorder_kernel"] == 0
          and max_err["scan_kernel"] == 0 and same(xr[0], rk) and same(xr[1], rv),
          f"K5, K4 and K6 == plain per pass on the headline radix sort (2^26, 2 columns, "
          f"{radix.digit_widths(32)} bits, tile {rtile})")

    # Per-call times at the headline shapes, back to back after a warm-up
    # (pass 0 of the headline radix sort; K4 as the public scan of 2^26).
    def ms(fn, *args, iters=20):
        return device_time(fn, *args, warmup=2, iters=iters) * 1e3

    def cold_ms(fn, *args, iters=10):
        """Mean ms of single calls, each after a 128 MB write that leaves
        none of its input in the 50 MB L2 (a call that reads what the last
        call left there beats its bytes bound)."""
        flush = torch.empty(1 << 25, dtype=torch.int32, device=dev)
        fn(*args)
        events = []
        for _ in range(iters):
            flush.fill_(0)
            timed(lambda: fn(*args), events)
        return sum(elapsed_ms(events)) / iters

    n = HEADLINE_N
    u0 = keys.view(torch.int32)
    xr = torch.stack([u0, iota.view(torch.int32)])
    hist0 = radix.digit_histogram(u0, bit=0, tile=rtile, digit_bits=wbits)
    offs0 = radix.bucket_offsets(hist0)
    nb = hist0.shape[1]
    rows["scan_kernel"] = dict(
        ms=ms(lambda x: scan.scan_kernel(x, inclusive=True), u0),
        plain_ms=ms(lambda x: scan.scan_plain(x, inclusive=True), u0, iters=5),
        bytes=8 * n, ops=n,
        library_ms=ms(lambda x: torch.cumsum(x, 0, dtype=torch.int32), u0))
    nbk = 1 << wbits  # the wide table's digits
    rows["digit_histogram_kernel"] = dict(
        ms=ms(lambda x: radix.digit_histogram(x, bit=0, tile=rtile, digit_bits=wbits), u0),
        plain_ms=ms(lambda x: radix.digit_histogram_plain(x, bit=0, tile=rtile,
                                                          digit_bits=wbits), u0, iters=5),
        bytes=4 * n + 4 * nbk * nb, ops=2 * n, library_ms=None)
    rows["reorder_kernel"] = dict(
        ms=ms(lambda x: radix.reorder_pass(x, offs0, bit=0, tile=rtile, out=yr,
                                           digit_bits=wbits), xr),
        plain_ms=ms(lambda x: radix.reorder_pass_plain(x, offs0, bit=0, tile=rtile, out=yr,
                                                       digit_bits=wbits), xr, iters=3),
        bytes=2 * 2 * 4 * n + 4 * nbk * nb, ops=2 * n, library_ms=None)
    # K3 at the headline size, on the sorted u64 keys (a gate's full read),
    # each call with a cold L2
    hi64, lo64 = common.to_sortable_u64_cols(r64k)
    max_err["disorder_cols_kernel"] = max(max_err["disorder_cols_kernel"], u32_err(
        checksort.disorder_cols_kernel(hi64, lo64), checksort.disorder_cols_plain(hi64, lo64)))
    rows["disorder_cols_kernel"] = dict(
        ms=cold_ms(checksort.disorder_cols_kernel, hi64, lo64),
        plain_ms=ms(checksort.disorder_cols_plain, hi64, lo64, iters=5),
        bytes=2 * 4 * n + 4, ops=2 * (n - 1), library_ms=None)
    check(max_err["disorder_cols_kernel"] == 0, "K3 == plain on the sorted u64 keys at 2^26")
    del hi64, lo64
    # K2 at the headline size, 20 calls back to back on the sorted keys
    rows["disorder_kernel"] = dict(
        ms=ms(checksort.disorder_kernel, u), plain_ms=ms(checksort.disorder_plain, u, iters=5),
        bytes=4 * n + 4, ops=n - 1, library_ms=None)
    print(json.dumps({"calls_of": "disorder_kernel", "n": n, "back_to_back_calls": 20,
                      "ms": rows["disorder_kernel"]["ms"],
                      "bound_ms": bound(4 * n + 4, n - 1)[0]}))
    before = _build.SCAN.launches
    radix.bucket_offsets(hist0)
    table_launches = _build.SCAN.launches - before
    table_ms = ms(radix.bucket_offsets, hist0)
    table_plain_ms = ms(lambda h: scan.scan_plain(h.reshape(-1)), hist0)
    print(json.dumps({"calls_of": "scan_kernel", "radix_table_entries": nbk * nb,
                      "launches_per_table_scan": table_launches, "ms": table_ms,
                      "plain_ms": table_plain_ms,
                      "bound_ms": bound(8 * nbk * nb, nbk * nb)[0]}))
    # Beside each K6 time, a device copy_ of the same (n_arr, n) columns: the
    # rate this card reaches for a plain read and write of those bytes.
    def copy_ms(x, y):
        return ms(lambda a: y.copy_(a), x)

    print(json.dumps({"calls_of": "reorder_kernel", "columns": 1, "digit_bits": wbits,
                      "ms": ms(lambda x: radix.reorder_pass(x, offs0, bit=0, tile=rtile,
                                                            out=yr[:1], digit_bits=wbits),
                               xr[:1]),
                      "copy_ms": copy_ms(xr[:1], yr[:1]),
                      "bound_ms": bound(2 * 4 * n + 4 * nbk * nb, 2 * n)[0]}))
    print(json.dumps({"calls_of": "reorder_kernel", "columns": 2, "digit_bits": wbits,
                      "ms": rows["reorder_kernel"]["ms"], "copy_ms": copy_ms(xr, yr),
                      "bound_ms": bound(rows["reorder_kernel"]["bytes"], 2 * n)[0]}))
    # pass 0 of the 64-bit key + rank radix sort: lo, carrying hi and the rank
    x3 = torch.stack([*common.to_sortable_u64_cols(k64)[::-1], iota.view(torch.int32)])
    y3 = torch.empty_like(x3)
    offs3 = radix.bucket_offsets(radix.digit_histogram(x3[0], bit=0, tile=rtile,
                                                       digit_bits=wbits))
    want = radix.reorder_pass_plain(x3, offs3, bit=0, tile=rtile, out=torch.empty_like(x3),
                                    digit_bits=wbits)
    err = u32_err(radix.reorder_pass(x3, offs3, bit=0, tile=rtile, out=y3, digit_bits=wbits),
                  want)
    max_err["reorder_kernel"] = max(max_err["reorder_kernel"], err)
    check(err == 0, "K6 == plain on pass 0 of the u64 key+rank radix sort (2^26, 3 columns)")
    print(json.dumps({"calls_of": "reorder_kernel", "columns": 3, "digit_bits": wbits,
                      "ms": ms(lambda x: radix.reorder_pass(x, offs3, bit=0, tile=rtile,
                                                            out=y3, digit_bits=wbits), x3),
                      "copy_ms": copy_ms(x3, y3),
                      "plain_ms": ms(lambda x: radix.reorder_pass_plain(
                          x, offs3, bit=0, tile=rtile, out=y3, digit_bits=wbits), x3, iters=3),
                      "bound_ms": bound(2 * 3 * 4 * n + 4 * nbk * nb, 2 * n)[0]}))
    del xr, yr, y3, want
    # 4 to 6 columns (the 64-bit radix paths with payloads), on pass 0 of
    # the same keys: extra random payload columns
    for cols in (4, 5, 6):
        xc = torch.cat([x3, torch.stack([rand_u32(n).view(torch.int32)
                                         for _ in range(cols - 3)])])
        yc = torch.empty_like(xc)
        want = radix.reorder_pass_plain(xc, offs3, bit=0, tile=rtile, out=torch.empty_like(xc),
                                        digit_bits=wbits)
        err = u32_err(radix.reorder_pass(xc, offs3, bit=0, tile=rtile, out=yc,
                                         digit_bits=wbits), want)
        max_err["reorder_kernel"] = max(max_err["reorder_kernel"], err)
        check(err == 0, f"K6 == plain on pass 0 at 2^26 with {cols} columns")
        del want
        print(json.dumps({"calls_of": "reorder_kernel", "columns": cols, "digit_bits": wbits,
                          "ms": ms(lambda x: radix.reorder_pass(x, offs3, bit=0, tile=rtile,
                                                                out=yc, digit_bits=wbits), xc),
                          "copy_ms": copy_ms(xc, yc),
                          "plain_ms": ms(lambda x: radix.reorder_pass_plain(
                              x, offs3, bit=0, tile=rtile, out=yc, digit_bits=wbits), xc,
                              iters=3),
                          "bound_ms": bound(2 * cols * 4 * n + 4 * nbk * nb, 2 * n)[0]}))
        del xc, yc
    del x3

    # ---- the probes (P1-P9): this path's own counts --------------------------
    phase_mark("probes")
    # Each probe module runs as its script does (every case timed, the
    # batched sorts beside torch.sort); the counts are read, and then each
    # probe kernel is held against its plain version.
    torch.cuda.synchronize()
    _build.reset_launches()
    probe_rows = (explore_ce.main(dev, ce_all=True) + explore_blocksort.main(dev)
                  + explore_keys16.main(dev) + explore_scan.main(dev))
    torch.cuda.synchronize()
    probe_counts = _build.launch_counts()
    print(f"launches probe path: {json.dumps(probe_counts)}", flush=True)
    for k in _build.PROBE_KERNELS:
        check(probe_counts[k.name] > 0, f"{k.name} launched on the probe path "
              f"({probe_counts[k.name]})")
    for _, n_arr, variant, stable in explore_ce.cases(ce_all=True):
        max_err["explore_ce_kernel"] = max(max_err["explore_ce_kernel"], explore_ce.check(
            n_arr, variant, stable, device=dev))
        check(True, f"P1 {variant}, {n_arr} columns, stable={stable} == plain: smem and "
              f"regs, 16 and 0 stages, the probe's and a tie-heavy input, at "
              f"n = {explore_ce.CHECK_SIZES}, two launches in a row and one in place")
    err = explore_blocksort.check(dev)
    for name in ("blocksort_ce_kernel", "blocksort_stages_kernel",
                 "blocksort_stages_split_kernel"):
        max_err[name] = err
    check(err == 0, f"P2 == plain on {explore_blocksort.CE_CHECK_TILES} tiles in each cluster "
          f"size the card holds; P3 == plain on {explore_blocksort.STAGE_CHECK_TILES} tiles at "
          f"{explore_blocksort.CHECK_STAGES} stages, the host's split and each of "
          f"{explore_blocksort.RING_SPLITS}")
    max_err["keys16_stage_kernel"] = max_err["cummax_kernel"] = explore_keys16.check(dev)
    check(max_err["keys16_stage_kernel"] == 0,
          "P9 == plain: int32, uint16, int16, bfloat16 at reps 0, 1, 7, 16 and 256, and on "
          f"every 16-bit pattern at reps {explore_keys16.ALL_PATTERN_REPS}; P8 == "
          "plain: 1 to 2^24 elements, full-range, rising, negative and run-start inputs, and "
          f"a rising walk at the chain's edges, each launched {explore_scan.REPEATS} times")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = explore_scan.check(dev)
    for name in ("blocksum_kernel", "addback_kernel", "grid_copy_kernel", "chained_scan_kernel"):
        max_err[name] = err
    check(err == 0, "P4, P5, P6, P7 and the two-pass scan == plain: 1 block to 2^24, "
          "partial last chunks and tiles, full-range u32 and the probe's values; P7 at "
          f"{explore_scan.CHAIN_EDGE_TILES} tiles (whole tiles, n % 4 = 3, a view one element "
          f"in) and P6 at n = {explore_scan.copy_edge_sizes(sms)}, each launched "
          f"{explore_scan.REPEATS} times")
    sort_lines = [r for r in probe_rows if r.get("probe") == "P8" and "ok" in r]
    check(len(sort_lines) == 7 and all(r["ok"] for r in sort_lines),
          "the probe's 7 u16 sort lines at 2^24 (bitonic, radix, xla, both counting "
          "sorts, the Zipf pair) == torch.sort")
    for row in probe_rows:
        print(json.dumps(row))
    cluster, active = explore_scan.chain_clusters()
    check(cluster == explore_scan.CHAIN_CLUSTER and active >= 1,
          f"the chained scans run as clusters of {cluster} blocks, {active} resident at once")

    def probe_row(**match):
        return next(r for r in probe_rows if all(r.get(k) == v for k, v in match.items()))

    # P1's launch on this card, as the C launch computes it: the blocks
    # resident an SM and the grid at 2^24 and on one tile, every instance
    ce_cases = {}  # function id -> its first case
    for _, n_arr, variant, stable in explore_ce.cases(ce_all=True):
        ce_cases.setdefault(explore_ce.function_id(variant, n_arr, stable),
                            (n_arr, variant, stable))
    ce_design = []
    for fn, (n_arr, variant, stable) in sorted(ce_cases.items()):
        for form in explore_ce.FORMULATIONS:
            at = {n: explore_ce.ce_resident(variant, n_arr, stable, form, n)
                  for n in (explore_ce.N, explore_ce.T)}
            ce_design.append({"function": fn, "variant": variant, "columns": n_arr,
                              "formulation": form, **at[explore_ce.N],
                              "grid_1_tile": at[explore_ce.T]["grid"]})
    print(json.dumps({"ce_probe_design": {
        "problem": [explore_ce.PROBLEM_ROWS, explore_ce.PROBLEM_LANES],
        "threads": explore_ce.CE_THREADS, "buffers": explore_ce.CE_BUFFERS,
        "instances": ce_design}}))
    problems = explore_ce.N // explore_ce.PROBLEM
    check(len(ce_design) == 20 and all(
        d["blocks_per_sm"] >= 1 and d["grid_1_tile"] == explore_ce.T // explore_ce.PROBLEM
        and d["grid"] == min(problems, d["blocks_per_sm"] * d["sms"]) for d in ce_design),
          "every P1 instance can be resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor) "
          "and launches one block a problem on one tile, every resident block at 2^24")

    # the kernels line's row of each probe: the probe's own case (P1 at
    # 2 columns in registers, the shape of K1's key + rank stages; P2 on
    # one tile; P3's register kernel at 256 tiles and its split kernel on
    # one tile, where each runs; P9 int32 at reps 256, where its
    # operations, not its bytes, bound it); every probe kernel's calls
    # timed queued behind a sleep, so that a one-tile probe shows the
    # card's time, not its launch; bytes read
    # and written once; operations on the card's integer lanes as each
    # module counts them (P1 explore_ce.ops_per_pair: a two-word compare in
    # each direction and four selects a pair; P2, P3 a minimum or maximum
    # an element a stage, their adds issuing elsewhere; P9 a minimum or
    # maximum an int32 element a stage)
    p1 = probe_row(probe="P1", variant="roll", columns=2, formulation="regs")
    p2 = probe_row(probe="P2", tiles=1)
    p2_rate = probe_row(probe="P2", tiles=explore_blocksort.RATE_TILES)
    p3 = probe_row(probe="P3", tiles=explore_blocksort.RATE_TILES)
    p3_tile = probe_row(probe="P3", tiles=1)
    eb, sms = explore_blocksort, torch.cuda.get_device_properties(dev).multi_processor_count
    check(p3["split"] == 1 and p3_tile["split"] > 1 and p2["grid"] > 4 and p3_tile["grid"] > 4,
          f"P3 runs a ring a thread on {eb.RATE_TILES} tiles; one tile of P2 and of P3 runs "
          f"more than 4 blocks (P2 {p2['grid']}, P3 {p3_tile['grid']}, split {p3_tile['split']})")
    floor = p2["launch_floor_ms"]
    print(json.dumps({"blocksort_probe_design": {
        "ce_cluster": {r["tiles"]: r["cluster"] for r in probe_rows if r.get("probe") == "P2"},
        "ce_clusters_resident": {c: eb.ce_active(c, dev) for c in eb.CE_CLUSTERS},
        "ce_grid": {r["tiles"]: r["grid"] for r in probe_rows if r.get("probe") == "P2"},
        "stage_split_and_grid": {t: [eb.ring_split(t, sms), eb.stage_grid(t, eb.ring_split(
            t, sms))] for t in eb.STAGE_CHECK_TILES},
        "launch_floor_ms": floor, "cluster_launch_floor_ms": p2["cluster_launch_floor_ms"],
        "p2_1_tile_ms": p2["ms"], "p2_over_floor": p2["ms"] / floor,
        "p2_1_tile_ms_by_cluster": p2["ms_by_cluster"],
        "p2_256_tiles_ms": p2_rate["ms"], "p2_256_tiles_ms_by_cluster": p2_rate["ms_by_cluster"],
        "p2_256_tiles_copy_ms": p2_rate["copy_ms"],
        "p3_1_tile_ms": p3_tile["ms"], "p3_over_floor": p3_tile["ms"] / floor,
        "p3_1_tile_zero_stages_ms": p3_tile["ms_zero_stages"],
        "p3_1_tile_ms_by_split": p3_tile["ms_by_split"], "p3_256_tiles_ms": p3["ms"],
        "bound_ms_1_tile": {"p2": p2["bound_ms"], "p3": p3_tile["bound_ms"]}}}))
    p9 = probe_row(probe="P9", dtype="int32", reps=explore_keys16.RATE_REPS[-1])
    br = explore_scan.TWOPASS_BLOCK_ROWS[0]
    p4, p5, p6, p7 = (probe_row(probe=p, block_rows=br) for p in ("P4", "P5", "P6", "P7"))
    p8 = probe_row(probe="P8", case="cummax_1d")
    links = explore_scan.chain_layout(explore_scan.N)[1]
    print(json.dumps({"scan_probe_design": {
        "n": explore_scan.N, "chain_cluster": cluster, "max_active_clusters": active,
        "chain_links": links, "p7_ms": p7["ms"], "p7_us_per_link": p7["ms"] * 1e3 / links,
        "p8_ms": p8["ms"], "p8_us_per_link": p8["ms"] * 1e3 / links,
        "p6_ms": p6["ms"], "copy_ms": p6["library_ms"],
        "p6_over_copy": p6["ms"] / p6["library_ms"]}}))
    # P9 by lane type: the widened bfloat16 stage against int32's
    stage_design = {}
    for dt in explore_keys16.DTYPES:
        name = str(dt).removeprefix("torch.")
        for reps in explore_keys16.RATE_REPS:
            r = probe_row(probe="P9", dtype=name, reps=reps)
            stage_design[f"{name}_{reps}"] = {
                "ms": r["ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "share": r["bound_ms"] / r["ms"],
                "over_int32": r["ms"] / probe_row(probe="P9", dtype="int32", reps=reps)["ms"]}
    print(json.dumps({"keys16_stage_design": stage_design}))
    n_s = explore_scan.N
    nb_s = n_s // (br * explore_scan.LANES)
    n_p = explore_ce.N
    tile = explore_blocksort.ROWS * explore_blocksort.LANES
    n9 = explore_keys16.TOTAL_ROWS * explore_keys16.LANES
    for name, r, n_bytes, n_ops in (
            ("explore_ce_kernel", p1, 2 * 2 * 4 * n_p, explore_ce.stage_ops("roll", 2, True)),
            ("blocksort_ce_kernel", p2, 2 * 4 * tile,
             explore_blocksort.ALU_OPS_PER_ELEMENT * tile),
            ("blocksort_stages_kernel", p3, 2 * 4 * tile * explore_blocksort.RATE_TILES,
             explore_blocksort.ALU_OPS_PER_ELEMENT * explore_blocksort.NSTAGE * tile
             * explore_blocksort.RATE_TILES),
            ("blocksort_stages_split_kernel", p3_tile, 2 * 4 * tile,
             explore_blocksort.ALU_OPS_PER_ELEMENT * explore_blocksort.NSTAGE * tile),
            ("keys16_stage_kernel", p9, 2 * 4 * n9,
             explore_keys16.stage_ops(torch.int32, explore_keys16.RATE_REPS[-1], n9))):
        rows[name] = dict(ms=r["ms"], plain_ms=r["plain_ms"], bytes=n_bytes, ops=n_ops,
                          library_ms=None)
    # the scan probes at block_rows 512 and P8 at 2^24, each beside its one
    # library call (a sum, copy_, torch.cumsum, torch.cummax); one operation
    # an element
    for name, r, n_bytes in (
            ("blocksum_kernel", p4, 4 * n_s + 4 * nb_s),
            ("addback_kernel", p5, 8 * n_s + 4 * nb_s),
            ("grid_copy_kernel", p6, 8 * n_s),
            ("chained_scan_kernel", p7, 8 * n_s),
            ("cummax_kernel", p8, 8 * explore_keys16.N16)):
        rows[name] = dict(ms=r["ms"], plain_ms=r["plain_ms"], bytes=n_bytes, ops=r["n"],
                          library_ms=r["library_ms"])

    # ---- the mesh phase: its own counts, in its own processes --------------
    phase_mark("mesh")
    mesh_counts, mesh_err = mesh_phase(dev)
    for name, e in mesh_err.items():
        max_err[name] = max(max_err[name], e)
    print(f"launches mesh path (all ranks): {json.dumps(mesh_counts)}", flush=True)
    for name in MESH_KERNELS:
        check(mesh_counts[name] > 0, f"{name} launched on the mesh path ({mesh_counts[name]})")

    # ---- runtime and demos: the profiler, the demos, crossover, the probes --
    phase_mark("runtime and demos")
    runtime_counts, runtime_err = runtime_phase(dev)
    for name, e in runtime_err.items():
        max_err[name] = max(max_err[name], e)
    print(f"launches runtime and demos path: {json.dumps(runtime_counts)}", flush=True)

    phase_mark("checks and summary")
    # checked last, so that a run that fails it still prints its times
    new_k1 = {(str(a), str(k)) for a, k in NEW_K1}
    spilled = {f"{a},{k}": b for (a, k), b in tile_spills.items()
               if (a in ("2", "3") or (a, k) in new_k1) and b}
    spilled.update({f"global {a},{k}": b for (a, k), b in global_spills.items()
                    if (a, k) in new_k1 and b})
    check(len(tile_spills) == 26 and len(global_spills) == 26 and not spilled,
          f"bitonic_tile_kernel with 2 or 3 columns, and both K1 kernels of every "
          f"instance with 4 key words or 8 columns, spill no registers (ptxas spill "
          f"stores in bytes: {spilled})")
    check(len(reorder_spills) == len(radix.DIGIT_BITS) and not any(reorder_spills.values()),
          f"reorder_kernel spills no registers at any digit width (ptxas spill stores in "
          f"bytes: {reorder_spills})")
    check(len(ce_spills) == 20 and not any(ce_spills.values()),
          f"P1's 20 kernels (10 functions, smem and regs) spill no registers (ptxas spill "
          f"stores in bytes by (formulation, kind, columns, key words, column type): "
          f"{ce_spills})")
    check(sorted(scan_probe_spills) == [
              "addback_kernel", "blocksum_kernel", "chained_scan_kernelINS_6AddU32",
              "chained_scan_kernelINS_6MaxI32", "grid_copy_kernel"]
          and not any(scan_probe_spills.values()),
          f"the five kernels of csrc/explore_scan.cu spill no registers (ptxas spill stores "
          f"in bytes: {scan_probe_spills})")
    check(sorted(stage_spills) == ["stage32_kernel", "stage_bf16_kernel"]
          and not any(stage_spills.values()),
          f"P9's int32 and bfloat16 kernels spill no registers (ptxas spill stores in bytes: "
          f"{stage_spills})")
    check(len(blocksort_spills) == 8 and not any(blocksort_spills.values()),
          f"P2's two cluster sizes, P3's register kernel and its five splits spill no "
          f"registers (ptxas spill stores in bytes: {blocksort_spills})")
    kernels = []
    for k in _build.KERNELS:
        r = rows[k.name]
        b_ms, b_by = bound(r["bytes"], r["ops"])
        kernels.append({
            "name": k.name, "route": "cuda",
            "source": f"tpu_radix_sort_torch/csrc/{k.source}.cu",
            "replaces": REPLACES[k.name],
            "launches": (main_counts[k.name] + slice_counts[k.name] + probe_counts[k.name]
                         + mesh_counts[k.name] + runtime_counts[k.name]),
            "max_abs_err": max_err[k.name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": r["library_ms"],
        })
    sort_bound, _ = bound(2 * n_arr * 4 * HEADLINE_N, 0)
    print(json.dumps({"sort": {
        "n": HEADLINE_N, "tile": tile,
        # the tile kernel's exchange buffer: the key words, one spare in 33
        "smem_bytes_per_block": (tile + tile // 32) * 4 * n_keys,
        "ms": sort_ms, "keys_only_ms": keys_only_ms,
        "library_ms": lib_ms, "library": "torch.sort(stable=True) on the biased int32 keys",
        "bound_ms": sort_bound, "is_sorted_ms": gate_ms,
        "launches_per_sort": per_case["headline k+v 2^26"],
        "launches_per_keys_only_sort": per_case["keys-only 2^26"],
        "peak_mem_bytes_headline": peak_headline,
        "radix_ms": radix_ms, "radix_keys_only_ms": radix_keys_only_ms, "auto_ms": auto_ms,
        "radix_tile": rtile,
        "radix_launches_per_sort": per_case["radix k+v 2^26"],
        "radix_launches_per_keys_only_sort": per_case["radix keys-only 2^26"],
        "radix_engine_bound_ms": len(radix.digit_widths(32)) * (
            bound(rows["digit_histogram_kernel"]["bytes"], 0)[0]
            + bound(rows["reorder_kernel"]["bytes"], 0)[0] + bound(8 * nbk * nb, 0)[0]),
        "radix_early_exit_passes": passes,
        "prefix_sum_ms": prefix_ms, "prefix_sum_bound_ms": bound(8 * n, n)[0],
        "cumsum_ms": rows["scan_kernel"]["library_ms"],
        "peak_mem_bytes_all": torch.cuda.max_memory_allocated(),
        "seconds_total": time.perf_counter() - t_start,
        "phase_seconds": phase_seconds,
    }}))
    print(json.dumps({"sort64": wide}))
    print(json.dumps({"keys16": keys16}))
    print(json.dumps({"batched_segmented": slice_rows,
                      "launches_by_path": {"flat sort": main_counts,
                                           "batched and segmented": slice_counts,
                                           "probes": probe_counts,
                                           "mesh (all ranks)": mesh_counts,
                                           "runtime and demos": runtime_counts}}))
    print(json.dumps({"kernels": kernels}))



# ---- the mesh phase: parallel/ over torch.distributed ------------------------
# NCCL refuses two ranks of one communicator on one card, so the phase runs
# two worlds, spawned after the kernels are built: 4 gloo ranks that all use
# cuda:0 (each rank's kernels run on the card; its collectives cross through
# the host, comm.py's gloo staging), and 1 NCCL rank (comm.py's NCCL branch
# on device tensors). Their times are not multi-GPU times: four processes
# share one card and cross through the host.
MESH_RANKS = 4
MESH_SIZES = {
    "full": HEADLINE_N,  # 2^26 u32 key + iota rank, 2^24 a rank
    "wide": SLICE_N,  # u64 key + rank
    "seg": SLICE_N, "segs": 4096,  # benchmarks/workloads.py:236-259
    "rows": 1024, "row": SLICE_N // 1024,
    "d3": OPTION_N,  # the exchange at D = 3, Zipf keys
    "layout": 1 << 20,
    "overlap": OPTION_N,
    "nccl": 1 << 20,
    "merge_tree": OPTION_N,
}
MESH_GROUP_TIMEOUT_S = 600  # a stuck collective fails the rank
MESH_JOIN_TIMEOUT_S = 800
MESH_KERNELS = ("bitonic_tile_kernel", "bitonic_global_stage_kernel", "disorder_kernel",
                "disorder_cols_kernel", "scan_kernel")


def k1_calls(calls):
    """(tile calls, global calls) of a K1 schedule: one launch each."""
    return (sum(c[0] == "tile" for c in calls), sum(c[0] == "global" for c in calls))


def merge_tree_check(dev, n):
    """K1 on the exchange's merge-tree schedule against its plain version:
    3 columns (key, unique tie, payload) of n, runs of 2^16 and 2^10 in the
    alternating state, every call of ``merge_tree_schedule`` through the
    kernel and through ``stages_plain`` on the same input. Returns the
    largest difference of each K1 kernel."""
    import torch

    from tpu_radix_sort_torch.ops import bitonic

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    err = {"bitonic_tile_kernel": 0, "bitonic_global_stage_kernel": 0}
    tile = bitonic.resolve_tile(n, 3)
    for run in (1 << 16, 1 << 10):
        x = torch.stack([torch.randint(0, 1 << 12, (n,), dtype=torch.int32, device=dev,
                                       generator=gen),
                         torch.randperm(n, device=dev, generator=gen).to(torch.int32),
                         torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                                       generator=gen)])
        # the state after round k = run: runs sorted in alternating directions
        bitonic.stages_plain(x, bitonic._block_stages(2, run), 2)
        calls = bitonic.merge_tree_schedule(n, run, tile)
        for call in calls:
            got = bitonic.run_schedule(x.clone(), [call], n_keys=2, tile=tile)
            stages = call[1] if call[0] == "tile" else [call[1:]]
            want = bitonic.stages_plain(x.clone(), stages, 2)
            name = "bitonic_tile_kernel" if call[0] == "tile" else "bitonic_global_stage_kernel"
            err[name] = max(err[name], u32_err(got, want))
            x = got
        keys = x[:2].cpu().numpy().view(np.uint32)
        check(max(err.values()) == 0 and np.array_equal(np.lexsort(keys[::-1]), np.arange(n)),
              f"merge_tree_padded, n {n}, 3 columns, run {run}, tile {tile}: "
              f"{k1_calls(calls)} (tile, global) K1 calls == stages_plain, and sorted")
    return err


def _mesh_rank(rank, world, backend, init, out_dir, sizes, device):
    """One rank of a mesh world: drives the mesh paths, checks its shard of
    every result against the same slice of the single-device sort of the
    global array on the card and of the numpy golden (every rank makes the
    global inputs from the seed; rank 0 holds the card's result against the
    golden in full), checks the launch counts, and writes its records to
    ``mesh_rank<r>.json``. Any failed check raises."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    import tpu_radix_sort_torch as trt
    from tpu_radix_sort_torch import _build
    from tpu_radix_sort_torch.models.golden import golden_is_sorted, golden_prefix_sum, golden_sort
    from tpu_radix_sort_torch.ops import bitonic
    from tpu_radix_sort_torch.parallel import comm, dryrun, sharded
    from tpu_radix_sort_torch.parallel.mesh_sort import shard_length

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=MESH_GROUP_TIMEOUT_S),
                            **({"device_id": torch.device("cuda", torch.cuda.current_device())}
                               if backend == "nccl" else {}))
    mesh = dryrun.mesh_over(range(world))
    mesh3 = dryrun.mesh_over(range(3)) if world >= 3 else None
    group = mesh.get_group("x")
    comm.STATS.synchronize = True
    records = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)

    def lead(msg):
        if rank == 0:
            print(f"mesh {backend} x{world}: {msg}", flush=True)

    def agree(ok, what, grp=group):
        """A check that every rank of `grp` passes, or all raise."""
        bad = int(comm.psum(torch.tensor([0 if ok else 1], device=dev), grp)[0])
        if bad:
            raise CheckFailed(f"{bad} rank(s) failed: {what}")
        lead(f"check ok: {what}")

    def measure(label, fn, grp=group):
        # the ranks start together: one may have spent seconds on the golden
        dist.barrier(grp)
        if cuda:
            torch.cuda.synchronize()
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        _build.reset_launches()
        comm.STATS.reset()
        t0 = time.perf_counter()
        if cuda:
            ev[0].record()
        out = fn()
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = _build.launch_counts()
        rec = {"label": label, "launches": {k: counts[k] for k in MESH_KERNELS},
               **comm.STATS.as_dict(), "wall_ms": wall_ms}
        if cuda:
            coll = sum(a.elapsed_time(b) for a, b in comm.STATS.events)
            rec.update(span_ms=ev[0].elapsed_time(ev[1]), collective_event_ms=coll,
                       kernel_ms=ev[0].elapsed_time(ev[1]) - coll)
        records.append(rec)
        return out

    def rand_u32(n, hi=None):
        lo, hi = (-2**31, 2**31) if hi is None else (0, hi)
        return torch.randint(lo, hi, (n,), dtype=torch.int32, device=dev,
                             generator=gen).view(torch.uint32)

    def iota(n):
        return torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)

    def same_slice(got, ref, lengths=None, m=mesh):
        """This rank's shard of a result against the same slice of `ref`
        (a tensor on the card or a numpy array, of the global result)."""
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        me, d = m.get_local_rank("x"), m.size(0)
        n = len(ref[0])
        lens = lengths or [shard_length(n, d, r) for r in range(d)]
        lo = sum(lens[:me])
        for g, r in zip(got, ref):
            r = r[lo:lo + lens[me]]
            if isinstance(r, np.ndarray):
                g = g.cpu().numpy()
                if g.dtype != r.dtype or not np.array_equal(g.view(np.uint8), r.view(np.uint8)):
                    return False
            elif not same(g, r):
                return False
        return True

    def golden_ok(ref, want_fn):
        """Rank 0: the card's single-device result against the golden,
        ``want_fn()``; the other ranks pass."""
        if rank != 0:
            return True
        ref = ref if isinstance(ref, tuple) else (ref,)
        want = want_fn()
        want = want if isinstance(want, tuple) else (want,)
        return all(np.array_equal(r.cpu().numpy().view(np.uint8), w.view(np.uint8))
                   for r, w in zip(ref, want))

    def expect_k1(label, want):
        rec = next(r for r in records if r["label"] == label)
        got = (rec["launches"]["bitonic_tile_kernel"],
               rec["launches"]["bitonic_global_stage_kernel"])
        agree(got == want, f"{label}: K1 launches a rank (tile, global) {got} == {want}")

    # the first collective sets up the communicator; the first sort loads
    # the kernels and grows the allocator: neither is timed
    comm.all_gather(torch.zeros(1, device=dev), group)
    if world == 1:
        n = sizes["nccl"]
        keys, vals = rand_u32(n), iota(n)
        trt.mesh_sort(keys, vals, mesh=mesh)
        ref = trt.sort(keys, vals, values_are_ranks=True)
        gold = golden_ok(ref, lambda: golden_sort(keys.cpu().numpy(), vals.cpu().numpy()))
        for method in ("mesh", "exchange"):
            fn = trt.mesh_sort if method == "mesh" else trt.exchange_sort
            out = measure(f"{backend} {method}_sort k+v", lambda: fn(keys, vals, mesh=mesh))
            agree(gold and same_slice(out, ref) and comm.STATS.calls > 0,
                  f"{method}_sort over one {backend} rank, {n} u32 key + value, through "
                  f"comm.py's {backend} branch ({comm.STATS.calls} collectives) == the "
                  f"single-device sort == golden")
    else:
        n = sizes["full"]
        per = n // world
        keys, ranks = rand_u32(n), iota(n)
        k, v = sharded(mesh, "x", keys), sharded(mesh, "x", ranks)
        ref = trt.sort(keys, ranks, values_are_ranks=True)
        gold = golden_ok(ref, lambda: golden_sort(keys.cpu().numpy(), ranks.cpu().numpy()))
        lead(f"global 2^{n.bit_length() - 1} u32 key + rank, {per} a rank")
        for method in ("mesh", "exchange"):
            trt.sort(k, v, mesh=mesh, method=method)
        for method in ("auto", "exchange"):
            out = measure(f"{method} k+rank", lambda: trt.sort(k, v, mesh=mesh, method=method,
                                                               values_are_ranks=True))
            agree(gold and same_slice(out, ref),
                  f"sort(mesh=, method='{method}'), {n} u32 key + rank over {world} ranks "
                  f"== the single-device sort == golden")
            out = measure(f"{method} keys-only", lambda: trt.sort(k, mesh=mesh, method=method))
            agree(gold and same_slice(out, ref[0]),
                  f"sort(mesh=, method='{method}'), {n} u32 keys-only == the single-device "
                  f"sort == golden")
        # the local sort and 3 compare-splits of one merge each at D = 4; the
        # exchange: the local sort and the merge tree of the slotted branch
        for cols, kind in ((3, "k+rank"), (2, "keys-only")):
            t = bitonic.resolve_tile(per, cols)
            local = k1_calls(bitonic.sort_schedule(per, t))
            merge = k1_calls(bitonic.merge_schedule(per, t))
            splits = (world.bit_length() - 1) * world.bit_length() // 2
            expect_k1(f"auto {kind}", (local[0] + splits * merge[0],
                                       local[1] + splits * merge[1]))
            slot = 2 * per // world
            tree = k1_calls(bitonic.merge_tree_schedule(
                2 * per, slot, bitonic.resolve_tile(2 * per, cols)))
            expect_k1(f"exchange {kind}", (local[0] + tree[0], local[1] + tree[1]))
        sk, sv = sharded(mesh, "x", ref[0]), sharded(mesh, "x", ref[1])
        out = measure("check_order sorted", lambda: trt.sort(sk, sv, mesh=mesh,
                                                             check_order=True))
        rec = records[-1]["launches"]
        agree(same_slice(out, ref) and rec["bitonic_tile_kernel"] == 0
              and rec["bitonic_global_stage_kernel"] == 0 and rec["disorder_kernel"] >= 1,
              f"check_order=True on the sorted {n}: K2 gates ({rec['disorder_kernel']} "
              f"launches a rank), K1 does not run, output unchanged")
        del out, sk, sv

        scanned = measure("prefix_sum", lambda: trt.prefix_sum(k, mesh=mesh))
        ref_scan = trt.prefix_sum(keys)
        gold_scan = golden_ok(ref_scan, lambda: golden_prefix_sum(keys.cpu().numpy()))
        agree(gold_scan and same_slice(scanned, ref_scan)
              and records[-1]["launches"]["scan_kernel"] == 1,
              f"prefix_sum(mesh=), {n} u32: one K4 launch a rank, == the single-device scan "
              f"== golden")
        del scanned, ref_scan
        sorted_shard = sharded(mesh, "x", ref[0])
        for label, x, g in (("sorted", sorted_shard, ref[0]), ("unsorted", k, keys)):
            s_ok = measure(f"is_sorted {label}", lambda: trt.is_sorted(x, mesh=mesh))
            d_ct = measure(f"disorder_count {label}", lambda: trt.disorder_count(x, mesh=mesh))
            want_d = int(trt.disorder_count(g))
            good = s_ok == trt.is_sorted(g) and int(d_ct) == want_d
            if rank == 0:
                gn = g.cpu().numpy()
                good = (good and golden_is_sorted(gn) == s_ok
                        and int(np.sum(gn[:-1] > gn[1:])) == want_d)
            agree(good, f"is_sorted / disorder_count(mesh=) of the {label} {n} ({s_ok}, "
                  f"{int(d_ct)}) == single-device == golden")
        del keys, ranks, k, v, ref, sorted_shard

        n = sizes["wide"]
        keys64 = torch.randint(-2**63, 2**63 - 1, (n,), dtype=torch.int64, device=dev,
                               generator=gen)
        keys64[: n // 2] = (keys64[: n // 2] & 0xFFFF) | (7 << 32)  # shared hi words
        keys64 = keys64.view(torch.uint64)
        r64 = iota(n)
        ref = trt.sort(keys64, r64, values_are_ranks=True)
        gold = golden_ok(ref, lambda: golden_sort(keys64.cpu().numpy(), r64.cpu().numpy()))
        k, v = sharded(mesh, "x", keys64), sharded(mesh, "x", r64)
        for method in ("mesh", "exchange"):
            out = measure(f"u64 {method} k+rank", lambda: trt.sort(k, v, mesh=mesh,
                                                                   method=method))
            agree(gold and same_slice(out, ref),
                  f"sort(mesh=, method='{method}'), {n} u64 key + rank == the single-device "
                  f"sort == golden")
        s_ok = measure("u64 is_sorted", lambda: trt.is_sorted(out[0], mesh=mesh))
        agree(s_ok and records[-1]["launches"]["disorder_cols_kernel"] >= 1,
              "is_sorted(mesh=) of the sorted u64 keys: K3 on every rank")
        del keys64, r64, ref, k, v, out

        n, segs = sizes["seg"], sizes["segs"]
        nrng = np.random.default_rng(SEED)
        w = nrng.zipf(1.3, segs).astype(np.float64)
        seg_sizes = nrng.multinomial(n - segs, w / w.sum()).astype(np.int64) + 1
        offs = np.concatenate([[0], np.cumsum(seg_sizes)])
        keys = rand_u32(n)
        ref = trt.sort_segments(keys, torch.from_numpy(offs).to(dev))
        kn = keys.cpu().numpy() if rank == 0 else None
        gold = golden_ok(ref, lambda: kn[np.lexsort((kn, np.repeat(np.arange(segs),
                                                                    seg_sizes)))])
        out = measure("sort_segments", lambda: trt.sort_segments(
            sharded(mesh, "x", keys), offs, mesh=mesh))
        rec = records[-1]["launches"]
        agree(gold and same_slice(out, ref) and rec["scan_kernel"] >= 1,
              f"sort_segments(mesh=), {n} u32, S = {segs} Zipf segments (K4 {rec['scan_kernel']}"
              f" launches a rank) == the single-device sort == golden")
        del keys, ref, out

        rows, row = sizes["rows"], sizes["row"]
        kb = rand_u32(rows * row).view(rows, row)
        ref = trt.sort_batched(kb)
        gold = golden_ok(ref, lambda: np.sort(kb.cpu().numpy(), axis=1))
        out = measure("sort_batched", lambda: trt.sort_batched(sharded(mesh, "x", kb),
                                                               mesh=mesh))
        agree(gold and same_slice(out, ref) and records[-1]["calls"] == 0,
              f"sort_batched(mesh=), {rows} x {row} u32: no collective, == the single-device "
              f"sort == golden")
        del kb, ref, out

        n = sizes["d3"]
        zk = torch.from_numpy(np.random.default_rng(SEED).zipf(1.3, n).astype(np.uint32)).to(dev)
        zv = iota(n)
        if mesh3 is not None:
            ref = trt.sort(zk, zv, values_are_ranks=True)
            gold = golden_ok(ref, lambda: golden_sort(zk.cpu().numpy(), zv.cpu().numpy()))
            out = measure("exchange D=3 zipf", lambda: trt.exchange_sort(
                sharded(mesh3, "x", zk), sharded(mesh3, "x", zv), mesh=mesh3),
                grp=mesh3.get_group("x"))
            agree(gold and same_slice(out, ref, m=mesh3),
                  f"exchange_sort at D = 3, {n} Zipf u32 key + rank == the single-device "
                  f"sort == golden", grp=mesh3.get_group("x"))
            del ref, out
        dist.barrier()

        n = sizes["layout"]
        cnt = n - 5  # not a multiple of 4
        lengths = [n // 2 + 3, 0, n // 4 - 1, n - (n // 2 + 3) - (n // 4 - 1)]
        lk = rand_u32(n)
        lk.view(torch.int32)[::7] = -1  # real all-ones keys on every shard, beside the pads
        lv = iota(n)
        me = mesh.get_local_rank("x")
        lo = sum(lengths[:me])
        pk, pv = lk[lo:lo + lengths[me]], lv[lo:lo + lengths[me]]
        ref = trt.sort(lk, lv, count=cnt, values_are_ranks=True)
        gold = golden_ok(ref, lambda: golden_sort(lk.cpu().numpy(), lv.cpu().numpy(),
                                                    count=cnt))
        for method in ("mesh", "exchange"):
            out = measure(f"layout {method}", lambda: trt.sort(pk, pv, mesh=mesh, count=cnt,
                                                               method=method))
            agree(gold and same_slice(out, ref, lengths),
                  f"layout: {n} u32 with real 0xFFFFFFFF keys, count {cnt}, shards {lengths}, "
                  f"sort(mesh=, method='{method}') == the single-device sort == golden")
        del lk, lv, pk, pv, ref, out

        n = sizes["overlap"]
        ok_, ov = rand_u32(n, 1 << 12), iota(n)
        ref = trt.sort(ok_, ov, values_are_ranks=True)
        gold = golden_ok(ref, lambda: golden_sort(ok_.cpu().numpy(), ov.cpu().numpy()))
        out = measure("mesh overlap_chunks=4", lambda: trt.mesh_sort(
            sharded(mesh, "x", ok_), sharded(mesh, "x", ov), mesh=mesh, overlap_chunks=4))
        agree(gold and same_slice(out, ref),
              f"mesh_sort(overlap_chunks=4), {n} u32 key + rank == the single-device sort "
              f"== golden")
        del ok_, ov, ref, out

        measure("dryrun_multichip(4)", lambda: dryrun.dryrun_multichip(world, device=dev))
        agree(True, f"dryrun_multichip({world}): its 12 checks")

    with open(f"{out_dir}/mesh_rank{rank}.json", "w") as f:
        json.dump({"rank": rank, "backend": dist.get_backend(group), "world": world,
                   "records": records}, f)
    dist.barrier()
    dist.destroy_process_group()


def _spawn_mesh_world(world, backend, sizes, device, tmp):
    """Run `world` ranks of :func:`_mesh_rank`; a rank that fails makes the
    others stop and this raise. Returns every rank's records."""
    import os

    import torch.multiprocessing as mp

    init = os.path.join(tmp, f"init-{backend}")
    ctx = mp.start_processes(_mesh_rank, args=(world, backend, init, tmp, sizes, device),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_JOIN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            raise CheckFailed(f"the {backend} mesh world did not end in {MESH_JOIN_TIMEOUT_S} s")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"mesh_rank{r}.json")) as f:
            out.append(json.load(f))
        os.remove(os.path.join(tmp, f"mesh_rank{r}.json"))
    return out


def mesh_phase(dev, sizes=MESH_SIZES):
    """The mesh phase (see above MESH_RANKS): K1's merge tree against its
    plain version in this process, then the two worlds. Prints each rank's
    launch counts, bytes and times, and one ``{"mesh": ...}`` JSON line.
    Returns (the launches of the two worlds summed by kernel, K1's largest
    differences from the merge-tree check)."""
    import tempfile

    import torch

    from tpu_radix_sort_torch import _build

    err = merge_tree_check(dev, sizes["merge_tree"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the earlier phases' blocks, for the ranks
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip() if dev.type == "cuda" else "cpu"
    counts = {k.name: 0 for k in _build.KERNELS}
    worlds = {}
    with tempfile.TemporaryDirectory() as tmp:
        for world, backend in ((MESH_RANKS, "gloo"), (1, "nccl" if dev.type == "cuda"
                                                      else "gloo")):
            t0 = time.perf_counter()
            ranks = _spawn_mesh_world(world, backend, sizes, str(dev), tmp)
            name = f"{backend} x{world}"
            cases = {}
            for r in ranks:
                check(r["backend"] == backend, f"rank {r['rank']} of the {name} world "
                      f"ran on {r['backend']}")
                for rec in r["records"]:
                    for k, c in rec["launches"].items():
                        counts[k] += c
                    c = cases.setdefault(rec["label"], {
                        "ranks": [], "launches": [], "bytes_sent": [], "bytes_received": [],
                        "collectives": [], "wall_ms": [], "kernel_ms": [], "collective_ms": []})
                    c["ranks"].append(r["rank"])
                    c["launches"].append([rec["launches"][k] for k in MESH_KERNELS])
                    c["bytes_sent"].append(rec["bytes_sent"])
                    c["bytes_received"].append(rec["bytes_received"])
                    c["collectives"].append(rec["calls"])
                    c["wall_ms"].append(rec["wall_ms"])
                    c["kernel_ms"].append(rec.get("kernel_ms"))
                    c["collective_ms"].append(rec["seconds"] * 1e3)
            worlds[name] = {"seconds": time.perf_counter() - t0, "cases": cases}
            for label, c in cases.items():
                print(f"mesh {name} {label}, by rank {c['ranks']}: launches (K1 tile, K1 "
                      f"global, K2, K3, K4) {c['launches']}; bytes sent {c['bytes_sent']}, "
                      f"received {c['bytes_received']} in {c['collectives']} collectives; wall "
                      f"ms {c['wall_ms']}; of it device ms between collectives (CUDA events: "
                      f"kernels, copies, launch gaps) {c['kernel_ms']} and collective ms (host "
                      f"timer) "
                      f"{c['collective_ms']} "
                      f"[{smi}; {world} processes on one card]", flush=True)
    print(json.dumps({"mesh": {"card": smi, "caveat": "not multi-GPU times: the ranks of each "
                               "world share one card, and gloo's collectives cross through "
                               "the host", "launch_order": MESH_KERNELS, "sizes": sizes,
                               "worlds": worlds}}))
    return counts, err


# ---- runtime and demos ---------------------------------------------------------
# The host-side modules of the port, each driven as a user runs it: the
# profiler around one 2^26 sort a engine, the two demos, crossover and the
# five probes of benchmarks/ (``check``, then ``main``). Their launches count
# where a path runs (the traced sorts, the demos, each ``main``), not where a
# ``check`` holds a kernel against its plain version.
PROFILE_N = HEADLINE_N
DEMO_N = OPTION_N
DEMO_MESH_N = 1 << 22
PROFILE_ENGINES = ("bitonic", "radix")


def profile_sort(dev, method, keys, ranks, log_dir):
    """One key + rank sort through `method` under ``runtime.trace`` in an
    ``annotate("sort")`` span; the trace's kernel events of the port's
    kernels must equal the launch counter's delta. Returns the JSON record:
    the launches, the span, the card's busy time and share within it."""
    import torch

    import tpu_radix_sort_torch as trt
    from tpu_radix_sort_torch import _build
    from tpu_radix_sort_torch.ops import common
    from tpu_radix_sort_torch.runtime import annotate, profiler, trace

    torch.cuda.synchronize()
    _build.reset_launches()
    with trace(log_dir, device=dev):
        with annotate("sort"):
            out_k, out_v = trt.sort(keys, ranks, values_are_ranks=True, method=method)
            torch.cuda.synchronize()
    counts = {k: c for k, c in _build.launch_counts().items() if c}
    events = profiler.load_events(log_dir)
    traced = {k: c for k, c in profiler.kernel_counts(
        events, [k.name for k in _build.KERNELS]).items() if c}
    want_k, want_i = torch.sort(common.bias_i32(keys.view(torch.int32)), stable=True)
    check(same(out_k, common.bias_i32(want_k)) and same(out_v, want_i.to(torch.int32)),
          f"traced sort(method={method!r}), 2^26 u32 key + rank == torch.sort(stable=True)")
    check(counts and traced == counts,
          f"the trace of sort(method={method!r}) holds one kernel event a launch of the port's "
          f"kernels: {traced} == the launch counter's {counts}")
    busy = profiler.busy_share(events, "sort")
    return {"method": method, "launches": counts, **busy,
            "events_in_trace": len(events),
            "torch_kernel_events": sum(e.get("cat") == "kernel" for e in events)
            - sum(traced.values())}


def runtime_phase(dev):
    """The runtime and demos phase (see above PROFILE_N). Prints the busy
    share of each engine, the demos' and crossover's tables, and one JSON
    line each for profile, demos, crossover, stages, segmented, blockrows,
    msd and primitives. Returns (its launches by kernel, K1's largest
    difference from stages_plain in explore_stages.check)."""
    import os
    import shutil
    import tempfile

    import torch

    import tpu_radix_sort_torch as trt
    from tpu_radix_sort_torch import _build
    from tpu_radix_sort_torch.benchmarks import (crossover, explore_blockrows, explore_msd,
                                                 explore_primitives, explore_segmented,
                                                 explore_stages)
    from tpu_radix_sort_torch.examples import demo, demo_mesh
    from tpu_radix_sort_torch.ops import bitonic
    from tpu_radix_sort_torch.runtime import cpu_baseline

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    counts = {k.name: 0 for k in _build.KERNELS}
    seconds = {}

    def counted(fn, *args, **kw):
        torch.cuda.synchronize()
        _build.reset_launches()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        for k, c in _build.launch_counts().items():
            counts[k] += c
        return out

    def phase(name):
        seconds[name] = time.perf_counter()
        print(f"-- {name} [{smi}]", flush=True)

    def done(name):
        seconds[name] = time.perf_counter() - seconds[name]
        print(f"-- {name}: {seconds[name]:.1f} s", flush=True)

    phase("native CPU baseline")
    check(cpu_baseline.native_available(),
          f"the native CPU sort builds and loads ({cpu_baseline.library_path()})")
    done("native CPU baseline")

    phase("profile")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    keys = torch.randint(-2**31, 2**31, (PROFILE_N,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    ranks = torch.arange(PROFILE_N, dtype=torch.int32, device=dev).view(torch.uint32)
    profile = {}
    tmp = tempfile.mkdtemp(prefix="trs_trace_")
    try:
        for method in PROFILE_ENGINES:
            trt.sort(keys, ranks, values_are_ranks=True, method=method)  # warm
            rec = profile_sort(dev, method, keys, ranks, os.path.join(tmp, method))
            for k, c in rec["launches"].items():
                counts[k] += c
            profile[method] = rec
            print(f"busy share, sort(method={method!r}) 2^26 u32 key + rank under the "
                  f"profiler: {rec['busy_share']:.4f} ({rec['busy_ms']:.3f} of "
                  f"{rec['span_ms']:.3f} ms; launches {rec['launches']}) [{smi}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tile = bitonic.resolve_tile(PROFILE_N, 2)
    tiles, globals_ = k1_calls(bitonic.sort_schedule(PROFILE_N, tile))
    got = profile["bitonic"]["launches"]
    check(got.get("bitonic_tile_kernel") == tiles and got.get("bitonic_global_stage_kernel")
          == globals_, f"the traced bitonic sort made the schedule's {tiles} tile and "
          f"{globals_} global K1 launches at tile {tile}")
    print(json.dumps({"profile": {"card": smi, "n": PROFILE_N, "engines": profile}}))
    del keys, ranks
    done("profile")

    phase("demo")
    demos = {}
    full = ["--n", str(PROFILE_N), "--values", "--ranks"]
    for label, argv in (("values ranks 2^26", full),
                        ("check-order consecutive 4", ["--n", str(DEMO_N), "--check-order",
                                                       "--consecutive", "4"]),
                        ("packed", ["--n", str(DEMO_N), "--packed"]),
                        ("uint64 check-order", ["--n", str(DEMO_N), "--dtype", "uint64",
                                                "--check-order"])):
        r = counted(demo.main, argv)
        keys_np = r["keys"]
        if "uint64" in label:
            ok = np.array_equal(r["out"], np.sort(keys_np))
        else:
            want_k, want_v = cpu_baseline.cpu_sort(keys_np, np.arange(keys_np.size,
                                                                     dtype=np.uint32))
            if label == "packed":
                rec = r["out"].reshape(-1, 2)
                ok = np.array_equal(rec[:, 0], want_k) and np.array_equal(rec[:, 1], want_v)
            elif "values" in label:
                ok = np.array_equal(r["out"][0], want_k) and np.array_equal(r["out"][1], want_v)
            else:
                ok = np.array_equal(r["out"], want_k) and np.array_equal(r["fed_out"], want_k)
        check(ok and r["timer"] == "device", f"demo {label}: output == the CPU sort")
        demos[label] = {k: r[k] for k in ("t_dev", "t_rest", "t_sort", "t_cpu", "cpu_kind")}
    done("demo")

    phase("demo_mesh")
    r = demo_mesh.main(["--devices", "4", "--n", str(DEMO_MESH_N), "--values", "--scan"])
    for k, c in r["launches"].items():
        counts[k] += c
    check(len(r["rows"]) == 5 and all(row["golden_exact"] for row in r["rows"]),
          f"demo_mesh 4 ranks ({r['backend']} on {sorted(set(r['rank_devices']))}), 2^22 u32 "
          f"key + value, both strategies and the scan: golden-exact")
    demos["mesh"] = {"backend": r["backend"], "rank_devices": r["rank_devices"],
                     "cards": r["cards"], "rows": r["rows"], "launches": r["launches"]}
    print(json.dumps({"demos": {"card": smi, **demos}}))
    done("demo_mesh")

    err = {}
    for name, mod, label in ((("crossover", crossover, "crossover"),
                              ("explore_stages", explore_stages, "stages"),
                              ("explore_segmented", explore_segmented, "segmented"),
                              ("explore_blockrows", explore_blockrows, "blockrows"),
                              ("explore_msd", explore_msd, "msd"),
                              ("explore_primitives", explore_primitives, "primitives"))):
        phase(name)
        e = mod.check(dev)
        check(e == 0, f"{name}.check: every row == its reference on the card")
        if name == "explore_stages":
            err["bitonic_tile_kernel"] = err["bitonic_global_stage_kernel"] = e
        rows = counted(mod.main, dev)
        torch.cuda.empty_cache()
        print(json.dumps({label: {"card": smi, "rows": rows}}))
        done(name)
    print(json.dumps({"runtime_phase_seconds": seconds}))
    return counts, err


if __name__ == "__main__":
    sys.exit(main())
