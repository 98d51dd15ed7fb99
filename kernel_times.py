#!/usr/bin/env python3
"""Time the port's redesigned kernels and the sorts around them, for one
checkout of the repository, on one CUDA card.

    python3 kernel_times.py [--root DIR] [--label NAME]
                            [--scan-probes-only | --ce-probe-only |
                             --keys16-probe-only | --blocksort-probe-only |
                             --sass]

imports ``tpu_radix_sort_torch`` from DIR (default: beside this script),
builds its kernels there, and prints one JSON line: the card's name and power
limit; K4 on 2^26 u32 (inclusive scan) beside ``torch.cumsum``, and the radix
sort's table scan with its launches; K6 on pass 0 of the 2^26 radix sort
with 1, 2, 3 and 6 columns, each beside a device ``copy_`` of the same
columns and its bound (one read and one write of them at 3.35 TB/s); the K1
tile kernel's phase-1 call and mean merge-tail call, replayed call by call
on the 2^26 u32 key+rank (2 columns) and u64 key+rank (3 columns) networks;
the 2^26 key+rank sorts through both engines beside ``torch.sort`` and the
bfloat16 key+rank radix sort; a tile call with no stages (the
device-memory round trip alone); and the scan probes on the probe's values
(``benchmarks/explore_scan.py``, ``explore_keys16.py``): the copy P6
(``explore_scan.grid_copy``) beside ``copy_`` at 2^24, the chained scan P7
(``explore_scan.streaming_scan``) beside ``torch.cumsum`` at 2^22, 2^23
and 2^24 with the chain's links (its clusters, or its tiles where the
checkout chains tile by tile) and the time a link, the running max P8
(``explore_keys16.cummax_1d``) beside ``torch.cummax`` and the scatter
counting sort at 2^24 u16 keys, each probe call queued behind a sleep.
Every time is the mean of CUDA-event windows after a warm-up. Running it
on two checkouts in turns on one machine (A, B, B, A) compares them on one
card. It uses only entry points that every slice of the port has had since
the scan probes.

``--radix-only`` builds only ``radix.cu`` and ``scan.cu`` and times K5 and
K6 on pass 0 of uniform keys at 2^26 and at 30,000,000 (the splat frame's
length: a partial last tile) for every digit width the checkout's engine
takes (2 bits, and 4, 6 and 8 where it has them; 8 at tiles 2^12 to 2^16),
K6 with 1 to 6 columns, each beside a ``copy_`` of the same columns and its
bound, K6 once on the entropy cell's keys (the AND of 5 uniform words: one
hot digit), and each width's pass checked once against its plain version;
then the 2^26 key+index sort through ``'auto'``, the same sort through the
radix engine with ``check_order=True`` (16 passes of 2 bits) and the 30M u64
key + u32 payload sort by 44 bits (the flat and splat cells' calls), each
beside its passes. ``--ce-probe-only`` builds only ``explore_ce.cu`` and times every case of
the compare-exchange probe P1 (``explore_ce.cases(ce_all=True)``) at 2^24 in
both formulations, at 16 and at 0 stages, each beside a ``copy_`` of the
same columns, every call queued behind a sleep. ``--keys16-probe-only``
builds only ``explore_keys16.cu`` and times the stage probe P9
(``explore_keys16.stage_rate``) for its four lane types at reps 16 and
256 on the probe's 32,768 seeded rows, every call queued behind a sleep,
beside each case's bound and the plain version's time.
``--blocksort-probe-only`` builds only ``explore_blocksort.cu`` and times
P2 (``explore_blocksort.ce_tiles``) and P3 (``stage_tiles``, at 64 and 0
stages) on 1 and 256 seeded tiles, and, where the checkout has them, the
launch floor (an empty launch), P2 on one tile in each cluster size and
P3 on one tile with each split of its rings, every call queued behind a
sleep. ``--sass`` builds the
probes' sources (``explore_ce``, ``explore_blocksort``, ``explore_keys16``)
and prints, for each of their kernels, the count of each SASS opcode that
``cuobjdump -sass`` shows (the instruction mix behind the operation counts
of their bounds).
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

N = 1 << 26
SEED = 20261017
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default=None)
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--scan-probes-only", action="store_true",
                      help="build and time only the scan probes P6, P7 and P8")
    only.add_argument("--ce-probe-only", action="store_true",
                      help="build and time only the compare-exchange probe P1")
    only.add_argument("--keys16-probe-only", action="store_true",
                      help="build and time only the stage probe P9")
    only.add_argument("--blocksort-probe-only", action="store_true",
                      help="build and time only the one-tile probes P2 and P3")
    only.add_argument("--radix-only", action="store_true",
                      help="build and time only K5 and K6 at each digit width, and two sorts")
    only.add_argument("--sass", action="store_true",
                      help="print the SASS opcode counts of the probes' kernels")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import tpu_radix_sort_torch as trt
    from tpu_radix_sort_torch import _build
    from tpu_radix_sort_torch.ops import bitonic, common, radix, scan
    from tpu_radix_sort_torch.runtime.timing import device_time

    assert Path(trt.__file__).resolve().is_relative_to(Path(args.root).resolve())
    sources = (["explore_scan", "explore_keys16"] if args.scan_probes_only
               else ["explore_ce"] if args.ce_probe_only
               else ["explore_keys16"] if args.keys16_probe_only
               else ["explore_blocksort"] if args.blocksort_probe_only
               else ["radix", "scan"] if args.radix_only
               else ["explore_ce", "explore_blocksort", "explore_keys16"] if args.sass else None)
    _build.build(sources)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    label = args.label or args.root
    if (args.scan_probes_only or args.ce_probe_only or args.keys16_probe_only
            or args.blocksort_probe_only or args.radix_only):
        key, fn = (("scan_probes", scan_probes) if args.scan_probes_only
                   else ("ce_probe", ce_probe) if args.ce_probe_only
                   else ("keys16_probe", keys16_probe) if args.keys16_probe_only
                   else ("radix", radix_times) if args.radix_only
                   else ("blocksort_probe", blocksort_probe))
        print(json.dumps({"kernel_times": {"label": label, "card": smi,
                                           key: fn(torch, device_time)}}), flush=True)
        return 0
    if args.sass:
        print(json.dumps({"sass": {"label": label, "card": smi,
                                   "opcodes": sass_counts(_build, sources)}}), flush=True)
        return 0

    def ms(fn, *a, iters=20):
        return device_time(fn, *a, warmup=2, iters=iters) * 1e3

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    keys = torch.randint(-2**31, 2**31, (N,), dtype=torch.int32, device="cuda",
                         generator=gen)
    iota = torch.arange(N, dtype=torch.int32, device="cuda")
    k64 = torch.randint(-2**63, 2**63 - 1, (N,), dtype=torch.int64, device="cuda",
                        generator=gen)
    out = {"label": args.label or args.root, "card": smi}

    hist = radix.digit_histogram(keys, bit=0, tile=radix.DEFAULT_TILE)
    before = _build.SCAN.launches
    radix.bucket_offsets(hist)
    table_launches = _build.SCAN.launches - before
    out["k4"] = {
        "ms_2p26": ms(lambda x: scan.scan_kernel(x, inclusive=True), keys),
        "cumsum_ms_2p26": ms(lambda x: torch.cumsum(x, 0, dtype=torch.int32), keys),
        "table_entries": hist.numel(),
        "table_ms": ms(radix.bucket_offsets, hist),
        "table_launches": table_launches,
    }

    # K6 on pass 0 at the checkout's default tile: the key column, the rank
    # and random payload columns
    tile = radix.DEFAULT_TILE
    offs0 = radix.bucket_offsets(radix.digit_histogram(keys, bit=0, tile=tile))
    x6 = torch.cat([torch.stack([keys, iota]),
                    torch.randint(-2**31, 2**31, (4, N), dtype=torch.int32, device="cuda",
                                  generator=gen)])
    out["k6"] = {"tile": tile}
    for cols in (1, 2, 3, 6):
        x, y = x6[:cols], torch.empty_like(x6[:cols])
        out["k6"][f"columns_{cols}"] = {
            "ms": ms(lambda a: radix.reorder_pass(a, offs0, bit=0, tile=tile, out=y), x),
            "copy_ms": ms(lambda a: y.copy_(a), x),
            "bound_ms": (2 * cols * 4 * N + 4 * offs0.numel()) / HBM_BYTES_PER_S * 1e3,
        }
        del x, y
    del x6

    def tile_calls(x, n_keys):
        n_arr, n = x.shape
        tile = bitonic.resolve_tile(n, n_arr)
        # warm-up: the first launch of a kernel loads its module
        bitonic.tile_stages(x[:, :2 * tile].clone(), bitonic._block_stages(2, tile),
                            n_keys=n_keys, tile=tile)
        # a call with no stages: the device-memory round trip alone
        empty_ms = ms(lambda y: bitonic.tile_stages(y, [], n_keys=n_keys, tile=tile), x,
                      iters=5)
        times = []
        for call in bitonic.sort_schedule(n, tile):
            if call[0] == "global":
                bitonic.global_stage(x, call[1], call[2], n_keys=n_keys)
                continue
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            bitonic.tile_stages(x, call[1], n_keys=n_keys, tile=tile)
            e.record()
            times.append((s, e))
        torch.cuda.synchronize()
        t = [s.elapsed_time(e) for s, e in times]
        return {"columns": n_arr, "tile": tile, "calls": len(t), "empty_call_ms": empty_ms,
                "phase1_ms": t[0],
                "merge_tail_mean_ms": sum(t[1:]) / len(t[1:]), "all_ms": sum(t)}

    hi, lo = common.to_sortable_u64_cols(k64.view(torch.uint64))
    out["k1_tile"] = {
        "u32_key_rank": tile_calls(torch.stack([keys, iota]), 2),
        "u64_key_rank": tile_calls(torch.stack([hi, lo, iota]), 3),
    }
    del hi, lo
    ku, iu, k64u = keys.view(torch.uint32), iota.view(torch.uint32), k64.view(torch.uint64)
    b16 = (keys & 0xFFFF).to(torch.int16).view(torch.bfloat16)
    out["sorts"] = {
        "u32_key_rank_ms": ms(lambda k, v: trt.sort(k, v, values_are_ranks=True), ku, iu,
                              iters=10),
        "u32_radix_ms": ms(lambda k, v: trt.sort(k, v, method="radix"), ku, iu, iters=10),
        "u32_torch_sort_ms": ms(lambda k: torch.sort(k ^ (-2**31), stable=True), keys,
                                iters=10),
        "u64_key_rank_ms": ms(lambda k, v: trt.sort(k, v, values_are_ranks=True), k64u, iu,
                              iters=10),
        "u64_radix_ms": ms(lambda k, v: trt.sort(k, v, method="radix"), k64u, iu, iters=10),
        "u64_torch_sort_ms": ms(lambda k: torch.sort(k ^ (-2**63), stable=True), k64,
                                iters=10),
        "bf16_radix_ms": ms(lambda k, v: trt.sort(k, v, method="radix"), b16, iu, iters=10),
    }
    out["scan_probes"] = scan_probes(torch, device_time)
    print(json.dumps({"kernel_times": out}), flush=True)
    return 0


def radix_times(torch, device_time) -> dict:
    """K5 and K6 of the checkout on pass 0 at each digit width and tile,
    1 to 6 columns, at 2^26 and 30M keys, and the flat, `check_order` and
    splat calls."""
    import tpu_radix_sort_torch as trt
    from tpu_radix_sort_torch import _build
    from tpu_radix_sort_torch.ops import radix

    def ms(fn, *a, iters=20):
        return device_time(fn, *a, warmup=2, iters=iters) * 1e3

    def gbound(n_bytes):
        return n_bytes / HBM_BYTES_PER_S * 1e3

    widths = getattr(radix, "DIGIT_BITS", (2,))
    wide = len(widths) > 1

    def kw(w):  # the checkout's wrappers take digit_bits where it has wide digits
        return {"digit_bits": w} if wide else {}

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    out = {"digit_bits": list(widths)}
    for n in (N, 30_000_000):
        x6 = torch.randint(-2**31, 2**31, (6, n), dtype=torch.int32, device="cuda",
                           generator=gen)
        ent = x6[1] & x6[2] & x6[3] & x6[4] & x6[5]  # CUB Entropy 0.201
        rows = {}
        for w in widths:
            tiles = ([radix.DEFAULT_TILE] if w == 2 else
                     sorted({radix.default_tile(n, w), *((1 << p) for p in range(12, 17))})
                     if w == 8 else [radix.default_tile(n, w)])
            for tile in tiles:
                hist = radix.digit_histogram(x6[0], bit=0, tile=tile, **kw(w))
                offs = radix.bucket_offsets(hist)
                row = {"k5_ms": ms(lambda a: radix.digit_histogram(a, bit=0, tile=tile, **kw(w)),
                                   x6[0]),
                       "k5_bound_ms": gbound(4 * n + 4 * hist.numel()),
                       "k4_table_ms": ms(radix.bucket_offsets, hist),
                       "table_entries": hist.numel()}
                x2 = x6[:2]
                got = radix.reorder_pass(x2, offs, bit=0, tile=tile, **kw(w))
                want = radix.reorder_pass_plain(x2, offs, bit=0, tile=tile,
                                                out=torch.empty_like(x2), **kw(w))
                row["k6_equals_plain"] = bool(torch.equal(got, want))
                del got, want
                for cols in range(1, 7):
                    x, y = x6[:cols], torch.empty_like(x6[:cols])
                    row[f"k6_{cols}"] = {
                        "ms": ms(lambda a: radix.reorder_pass(a, offs, bit=0, tile=tile, out=y,
                                                              **kw(w)), x),
                        "copy_ms": ms(lambda a: y.copy_(a), x),
                        "bound_ms": gbound(2 * cols * 4 * n + 4 * hist.numel())}
                    del x, y
                if not wide or tile == radix.default_tile(n, w):
                    xe = torch.stack([ent, x6[1]])
                    offe = radix.bucket_offsets(radix.digit_histogram(ent, bit=0, tile=tile,
                                                                      **kw(w)))
                    ye = torch.empty_like(xe)
                    row["k6_2_entropy_ms"] = ms(
                        lambda a: radix.reorder_pass(a, offe, bit=0, tile=tile, out=ye, **kw(w)),
                        xe)
                    del xe, ye, offe
                rows[f"w{w}_tile{tile}"] = row
        out[f"n{n}"] = rows
        del x6, ent
    # the cells' calls: flat (2^26 u32 key + index, 'auto') and splat (30M
    # u64 keys + u32 payload by their low 44 bits)
    k = torch.randint(-2**31, 2**31, (N,), dtype=torch.int32, device="cuda",
                      generator=gen).view(torch.uint32)
    iota = torch.arange(N, dtype=torch.int32, device="cuda").view(torch.uint32)
    sk, idx = torch.sort(k.view(torch.int32) ^ (-2**31), stable=True)
    # the flat call, and the one call that runs 2-bit passes: the radix
    # engine with the reference's order check (16 passes on random keys)
    for name, kw in (("flat_sort", {"values_are_ranks": True}),
                     ("check_order_sort", {"method": "radix", "check_order": True})):
        h0 = _build.DIGIT_HISTOGRAM.launches
        ok, ov = trt.sort(k, iota, **kw)
        passes = _build.DIGIT_HISTOGRAM.launches - h0
        same = bool(torch.equal(ok.view(torch.int32), sk ^ (-2**31))
                    and torch.equal(ov.view(torch.int32), idx.to(torch.int32)))
        del ok, ov
        out[name] = {"ms": ms(functools.partial(trt.sort, **kw), k, iota, iters=10),
                     "passes": passes, "equals_torch_sort": same}
    del k, iota, sk, idx
    n = 30_000_000
    k64 = torch.randint(-2**63, 2**63 - 1, (n,), dtype=torch.int64, device="cuda",
                        generator=gen).view(torch.uint64)
    v = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device="cuda",
                      generator=gen).view(torch.uint32)
    h0 = _build.DIGIT_HISTOGRAM.launches
    trt.sort(k64, v, bit_count=44)
    passes = _build.DIGIT_HISTOGRAM.launches - h0
    out["splat_sort"] = {"ms": ms(lambda a, b: trt.sort(a, b, bit_count=44), k64, v, iters=10),
                         "passes": passes}
    return out


def scan_probes(torch, device_time) -> dict:
    """P6, P7 and P8 of the checkout on the card, each beside its one
    library call."""
    from tpu_radix_sort_torch.benchmarks import explore_keys16 as ek
    from tpu_radix_sort_torch.benchmarks import explore_scan as es
    from tpu_radix_sort_torch.ops import common

    def ms(fn, *a, iters=20):
        return device_time(fn, *a, warmup=2, iters=iters, queued=True) * 1e3

    def links(n):  # one a cluster where the checkout chains clusters, else one a tile
        layout = getattr(es, "chain_layout", None)
        return layout(n)[1] if layout else common.cdiv(n, es.CHAIN_TILE)

    br = es.CHAIN_BLOCK_ROWS[0]
    out = {"chain_cluster": getattr(es, "CHAIN_CLUSTER", 1)}
    if hasattr(es, "chain_clusters"):
        out["max_active_clusters"] = es.chain_clusters()[1]
    for p in (22, 23, 24):
        x2d = es.probe_input("cuda", 0, 1 << p)
        t = ms(es.streaming_scan, x2d, br)
        out[f"p7_2p{p}"] = {"ms": t, "links": links(1 << p), "us_per_link": t * 1e3 / links(1 << p),
                            "cumsum_ms": ms(lambda x: torch.cumsum(x.view(-1), 0,
                                                                   dtype=torch.int32), x2d)}
    y = torch.empty_like(x2d)
    out["p6_2p24"] = {"ms": ms(es.grid_copy, x2d, br), "copy_ms": ms(lambda x: y.copy_(x), x2d),
                      "bound_ms": 8 * x2d.numel() / HBM_BYTES_PER_S * 1e3}
    del x2d, y
    rng = torch.Generator(device="cuda")
    rng.manual_seed(SEED)
    keys = torch.randint(0, 2**16, (ek.N16,), dtype=torch.int32, device="cuda",
                         generator=rng).to(torch.int16).view(torch.uint16)
    starts = ek.run_starts(ek.scatter_hist_u16(keys), ek.N16)
    out["p8_2p24"] = {"ms": ms(ek.cummax_1d, starts),
                      "cummax_ms": ms(lambda x: torch.cummax(x, 0), starts, iters=3),
                      "counting_sort_ms": ms(ek.counting_sort_u16, keys, iters=10)}
    return out


def ce_probe(torch, device_time) -> dict:
    """Every case of P1 at 2^24 in both formulations, at 16 and 0 stages,
    each beside a ``copy_`` of the same columns; every call queued behind
    a sleep."""
    from tpu_radix_sort_torch.benchmarks import explore_ce as ec

    def ms(fn, *a):
        return device_time(fn, *a, warmup=2, iters=20, queued=True) * 1e3

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    x = torch.randint(-2**31, 2**31, (ec.N,), dtype=torch.int32, device="cuda", generator=gen)
    out = {}
    for name, n_arr, variant, stable in ec.cases(ce_all=True):
        cols = ec.probe_columns(x, n_arr, variant)
        y = torch.empty_like(cols)
        row = {"variant": variant, "columns": n_arr, "stable": stable,
               "copy_ms": ms(y.copy_, cols)}
        for form in ec.FORMULATIONS:
            for n_stages in (ec.STAGES, 0):
                row[f"{form}_{n_stages}_ms"] = ms(
                    lambda c: ec.ce_stages(c, variant, stable, formulation=form,
                                           n_stages=n_stages), cols)
        out[name] = row
        del cols, y
    return out


def keys16_probe(torch, device_time) -> dict:
    """P9 for every lane type at each of the probe's reps (16 and 256):
    ``explore_keys16.stage_rate``'s row (the kernel's calls queued behind a
    sleep, its bound, the plain version's time)."""
    from tpu_radix_sort_torch.benchmarks import explore_keys16 as ek

    return {f"{str(dt).removeprefix('torch.')}_{reps}": ek.stage_rate(dt, reps, device="cuda")
            for dt in ek.DTYPES for reps in ek.RATE_REPS}


def blocksort_probe(torch, device_time) -> dict:
    """P2 and P3 on 1 and 256 seeded tiles (P3 at 64 and 0 stages) and,
    where the checkout has them, the launch floor, P2 on one tile in each
    cluster size the card holds and P3 on one tile with each split; every
    call queued behind a sleep."""
    from tpu_radix_sort_torch.benchmarks import explore_blocksort as eb

    def ms(fn, *a):
        return device_time(fn, *a, warmup=2, iters=20, queued=True) * 1e3

    out = {}
    for tiles in (1, eb.RATE_TILES):
        x = eb.random_tiles(tiles, SEED + tiles, "cuda")
        out[f"p2_{tiles}_ms"] = ms(eb.ce_tiles, x)
        out[f"p3_{tiles}_ms"] = ms(eb.stage_tiles, x)
        out[f"p3_{tiles}_zero_stages_ms"] = ms(lambda a: eb.stage_tiles(a, 0), x)
        if hasattr(eb, "ring_split"):
            out[f"p2_{tiles}_ms_by_cluster"] = {
                c: ms(lambda a, c=c: eb.ce_tiles(a, c), x)
                for c in eb.CE_CLUSTERS if eb.ce_active(c, "cuda") >= 1}
        if tiles == 1 and hasattr(eb, "ring_split"):
            out["p3_1_ms_by_split"] = {s: ms(lambda a, s=s: eb.stage_tiles(a, split=s), x)
                                       for s in eb.RING_SPLITS}
    if hasattr(eb, "launch_floor_ms"):
        out["launch_floor_ms"] = eb.launch_floor_ms("cuda")
        out["cluster_launch_floor_ms"] = {c: eb.launch_floor_ms("cuda", c)
                                          for c in out["p2_1_ms_by_cluster"]}
    return out


def sass_counts(build, sources) -> dict:
    """{kernel: {opcode: count}} over the SASS of the built sources, the
    opcode with its modifiers (``ISETP.GT.U32.AND``), predicates dropped."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    counts = {}
    for name in sources:
        text = subprocess.run([str(cuobjdump), "-sass", str(build._paths(name)[1])],
                              capture_output=True, text=True, check=True).stdout
        fn = None
        for line in text.splitlines():
            if m := re.match(r"\s*Function : (\S+)", line):
                fn = counts.setdefault(m.group(1), collections.Counter())
            elif fn is not None and (m := re.match(
                    r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)):
                fn[m.group(1)] += 1
    return {k: dict(sorted(v.items())) for k, v in counts.items()}


if __name__ == "__main__":
    sys.exit(main())
