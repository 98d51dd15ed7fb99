"""Probes P2 and P3 on the card, and the batched sort beside
``torch.sort(dim=1)``.

Counterpart of ``benchmarks/explore_blocksort.py``. That script times
``jax.lax.sort(dimension=1)`` over 2^24 u32 keys as (32, 2^19), (128, 2^17)
and (1024, 2^14) rows, and a 3-operand (key, idx, val) sort at 128 rows;
here each is ``torch.sort(dim=1)`` beside the port's ``sort_batched`` of the
same rows, byte-checked against ``torch.sort(stable=True)`` (the 3-operand
sort is ``sort_batched(keys, values)``). Then its two Pallas kernels, on
one 512 x 128 u32 tile each:

- P2 (``ce_kernel`` :42, launched :60), a primitive check:
  y[r] = x[(r - 8) mod 512]; z = min(x, y) where (r // 8) is even, else
  max (unsigned); z[:, l] <- z[:, (l - 1) mod 128]; then the inclusive sum
  down the rows, mod 2^32 (:func:`ce_plain`, :func:`ce_tiles`);
- P3 (``stages_kernel`` :74, launched :88), the stage rate: 64 times
  x <- (min(x, y) where (r // 8) is even, else max(x, y)) + 1 mod 2^32,
  with y as above (:func:`stages_plain`, :func:`stage_tiles`).

The kernels (``csrc/explore_blocksort.cu``) apply the per-tile function to
B independent tiles: B = 1, the probe's own shape, and B = 256 (2^24
elements) for a rate. One tile is spread over the card: P2 runs a tile as
one thread-block cluster of 8 or 16 blocks (:func:`choose_cluster`), and
P3 splits each of a tile's 1,024 rings across :func:`ring_split` lanes of
a warp when the tiles are too few to fill the SMs. An empty kernel gives
the card's cost of one launch (:func:`launch_floor_ms`), the floor under a
one-tile time. Tiles are int32 tensors of u32 patterns, (B, 512, 128) or
(512, 128).

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.explore_blocksort``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..ops import common
from ..ops.batched import sort_batched
from ..runtime.timing import device_time
from ..utils import interop
from . import ALU_OPS_PER_S, HBM_BYTES_PER_S

ROWS, LANES = 512, 128
NSTAGE = 64
SHIFT = 8  # the row roll of both kernels
RATE_TILES = 256
N = 1 << 24
# Operations on the card's 32-bit integer lanes (ALU_OPS_PER_S) an element
# (P2) or an element a stage (P3): the minimum or maximum. The add beside
# it (P2's running sum, P3's + 1) compiles to VIADD, which does not issue
# on those lanes: `kernel_times.py --sass` shows one VIMNMX and one VIADD
# an element a stage, and P3 runs both faster than the lanes could run the
# two (PERF.md).
ALU_OPS_PER_ELEMENT = 1
# P2: blocks of a tile's cluster (8 portable, 16 where the card holds it),
# and chunks of a block's band of rows: 128 lanes x 2 chunks, 256 threads a
# block (kCeChunks there).
CE_CLUSTERS = (8, 16)
CE_CHUNKS = 2
# P3: a tile's rings (a lane and a residue r mod 8 each) of 64 slots; the
# lanes of a warp that share a ring (S of the split kernel; 1, a ring a
# thread, is the register kernel), 256 threads a block (kStageThreads).
RINGS = LANES * SHIFT
RING_SPLITS = (1, 2, 4, 8, 16, 32)
STAGE_THREADS = 256
# The card's checks: P2's tile counts, P3's tile counts and stage counts
# (every split at each); each kernel against its plain version.
CE_CHECK_TILES = (1, 3, RATE_TILES)
STAGE_CHECK_TILES = (1, 2, 3, 33, RATE_TILES)
CHECK_STAGES = (0, 1, NSTAGE - 1, NSTAGE)


def stage_bound_ms(tiles: int, n_stages: int = NSTAGE) -> tuple[float, str]:
    """P3's least time on the card: its tiles read once and written once,
    or its stages' integer operations, whichever is longer; and which. P2's
    is that of one stage: one minimum or maximum an element."""
    t_bytes = tiles * 2 * 4 * ROWS * LANES / HBM_BYTES_PER_S * 1e3
    t_ops = tiles * ROWS * LANES * n_stages * ALU_OPS_PER_ELEMENT / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def choose_cluster(tiles: int, active: dict[int, int]) -> int:
    """P2's cluster size for `tiles` tiles on a card that holds
    ``active[c]`` clusters of c blocks at once: the largest size whose
    clusters for all the tiles are resident at once (a tile over the most
    SMs), else the smallest. Once tiles wait in waves, the smaller
    cluster's longer bands keep more bytes in flight (on the H100, 77
    clusters of 8 blocks of 36 KB of rows against 49 of 16 blocks of 20 KB)
    and read fewer rows twice (the 8 above each band)."""
    if tiles < 1:
        raise ValueError("choose_cluster takes tiles >= 1")
    usable = [c for c in CE_CLUSTERS if active.get(c, 0) >= 1]
    if not usable:
        raise RuntimeError(f"no cluster of {CE_CLUSTERS} blocks of P2 fits on the card")
    fits = [c for c in usable if active[c] >= tiles]
    return max(fits) if fits else min(usable)


def ring_split(tiles: int, sms: int) -> int:
    """The lanes of a warp that share each of P3's rings on `tiles` tiles
    on a card of `sms` SMs: the least split of ``RING_SPLITS`` whose blocks
    (:func:`stage_grid`) cover every SM, else the largest. 1 keeps a ring
    a thread; a larger split only adds a shuffle a stage once the SMs are
    full."""
    if tiles < 1 or sms < 1:
        raise ValueError("ring_split takes tiles >= 1 and sms >= 1")
    return next((s for s in RING_SPLITS if stage_grid(tiles, s) >= sms), RING_SPLITS[-1])


def stage_grid(tiles: int, split: int) -> int:
    """P3's blocks on `tiles` tiles: a thread for each ring's `split` parts."""
    return tiles * RINGS * split // STAGE_THREADS


def _tiles(x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError("the probe takes int32 tensors of u32 bit patterns")
    if x.shape[-2:] != (ROWS, LANES) or x.dim() not in (2, 3) or x.numel() == 0:
        raise ValueError(f"the probe takes ({ROWS}, {LANES}) tiles, as (B, {ROWS}, {LANES})"
                         f" or ({ROWS}, {LANES})")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.contiguous().view(-1, ROWS, LANES)


def _min_max(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """min(x, y) in rows whose (r // 8) is even, max elsewhere (unsigned)."""
    bx, by = common.bias_i32(x), common.bias_i32(y)
    take_lo = ((torch.arange(ROWS, device=x.device) // SHIFT) % 2 == 0)[:, None]
    return common.bias_i32(torch.where(take_lo, torch.minimum(bx, by), torch.maximum(bx, by)))


def ce_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P2, tile by tile."""
    shape, t = x.shape, _tiles(x)
    z = torch.roll(_min_max(t, torch.roll(t, SHIFT, dims=1)), 1, dims=2)
    z = torch.cumsum(z.to(torch.int64) & 0xFFFFFFFF, dim=1) & 0xFFFFFFFF
    return z.to(torch.int32).view(shape)


def stages_plain(x: torch.Tensor, n_stages: int = NSTAGE) -> torch.Tensor:
    """Plain version of P3, tile by tile."""
    shape, t = x.shape, _tiles(x)
    for _ in range(n_stages):
        t = _min_max(t, torch.roll(t, SHIFT, dims=1)) + 1
    return t.clone().view(shape)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def ce_active(cluster: int, device="cuda") -> int:
    """The clusters of `cluster` blocks of P2 that the CUDA device holds at
    once, from ``cudaOccupancyMaxActiveClusters`` (0: none)."""
    if cluster not in CE_CLUSTERS:
        raise ValueError(f"P2 runs in clusters of {CE_CLUSTERS} blocks, not {cluster}")
    dev = interop.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("ce_active asks a CUDA device")
    lib = _build.library("explore_blocksort")
    active = ctypes.c_int()
    with torch.cuda.device(dev):
        err = lib.trs_blocksort_ce_active(cluster, ctypes.byref(active))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed for clusters of {cluster}: "
                           f"CUDA error {err} ({lib.trs_error_string(err).decode()})")
    return active.value


def ce_cluster(tiles: int, device="cuda") -> int:
    """P2's cluster size for `tiles` tiles on the CUDA device
    (:func:`choose_cluster` on its :func:`ce_active` counts)."""
    return choose_cluster(tiles, {c: ce_active(c, device) for c in CE_CLUSTERS})


def ce_tiles(x: torch.Tensor, cluster: int | None = None) -> torch.Tensor:
    """P2's kernel on each tile, a tile a cluster of `cluster` blocks
    (default :func:`ce_cluster`). A CPU tensor runs :func:`ce_plain`."""
    t = _tiles(x)
    if cluster is not None and cluster not in CE_CLUSTERS:
        raise ValueError(f"P2 runs in clusters of {CE_CLUSTERS} blocks, not {cluster}")
    if t.device.type == "cpu":
        return ce_plain(x)
    if t.data_ptr() % 16:
        raise ValueError("P2's kernel copies its tiles in bulk: they must be 16-byte aligned")
    out = torch.empty_like(t)
    if cluster is None:
        cluster = ce_cluster(t.shape[0], t.device)
    _build.BLOCKSORT_CE(t.data_ptr(), out.data_ptr(), t.shape[0], cluster, _stream(t))
    return out.view(x.shape)


def stage_tiles(x: torch.Tensor, n_stages: int = NSTAGE,
                split: int | None = None) -> torch.Tensor:
    """P3's kernel: `n_stages` stages on each tile, resident in registers,
    each ring across `split` lanes of a warp (default :func:`ring_split`
    for the tiles on this card). A CPU tensor runs :func:`stages_plain`."""
    t = _tiles(x)
    if n_stages < 0:
        raise ValueError("n_stages must be >= 0")
    if split is not None and split not in RING_SPLITS:
        raise ValueError(f"a ring splits across {RING_SPLITS} lanes, not {split}")
    if t.device.type == "cpu":
        return stages_plain(x, n_stages)
    if split is None:
        split = ring_split(t.shape[0], torch.cuda.get_device_properties(
            t.device).multi_processor_count)
    out = torch.empty_like(t)
    if split == 1:
        _build.BLOCKSORT_STAGES(t.data_ptr(), out.data_ptr(), t.shape[0], n_stages, _stream(t))
    else:
        _build.BLOCKSORT_STAGES_SPLIT(t.data_ptr(), out.data_ptr(), t.shape[0], n_stages, split,
                                      _stream(t))
    return out.view(x.shape)


def launch_floor_ms(device="cuda", cluster: int = 1) -> float:
    """The card's time for one empty launch (one block of 32 threads, or
    one cluster of `cluster` such blocks), timed as the probes are: calls
    queued behind a sleep."""
    if cluster != 1 and cluster not in CE_CLUSTERS:
        raise ValueError(f"an empty launch of 1 or {CE_CLUSTERS} blocks, not {cluster}")
    anchor = torch.empty(1, device=interop.resolve_device(device))  # device_time's tensor

    def empty(a):
        _build.LAUNCH_FLOOR(cluster, _stream(a))

    return device_time(empty, anchor, queued=True) * 1e3


def random_tiles(tiles: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32, (tiles, ROWS, LANES), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(u.view(np.int32)).to(device)


def report(name, n, ms):
    print(f"{name:44s} n={n:>9d}  {ms:8.3f} ms  {n / ms / 1e6:7.2f} Gelem/s", flush=True)


def library_lines(device="cuda", seed=0) -> list[dict]:
    """``torch.sort(dim=1)`` at the probe's three shapes and the 3-operand
    sort at 128 rows, each beside ``sort_batched`` of the same rows, which
    must equal ``torch.sort(stable=True)`` byte for byte."""
    dev = interop.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rows = []
    for b in (32, 128, 1024):
        k = torch.randint(-2**31, 2**31, (b, N // b), dtype=torch.int32, device=dev,
                          generator=gen)
        biased = common.bias_i32(k)
        want = common.bias_i32(torch.sort(biased, dim=1, stable=True)[0])
        got = sort_batched(k.view(torch.uint32))
        if not torch.equal(got.view(torch.int32), want):
            raise AssertionError(f"sort_batched of ({b}, {N // b}) u32 differs from torch.sort")
        lib_ms = device_time(lambda w: torch.sort(w, dim=1), biased) * 1e3
        ms = device_time(sort_batched, k.view(torch.uint32)) * 1e3
        report(f"torch.sort batched [{b},{N // b}]", N, lib_ms)
        report(f"sort_batched [{b},{N // b}]", N, ms)
        rows.append({"probe": "explore_blocksort library", "rows": b, "row_len": N // b,
                     "ms": ms, "torch_sort_ms": lib_ms})
    b = 128
    k = torch.randint(-2**31, 2**31, (b, N // b), dtype=torch.int32, device=dev, generator=gen)
    v = torch.randint(-2**31, 2**31, (b, N // b), dtype=torch.int32, device=dev, generator=gen)
    biased = common.bias_i32(k)

    def lib(w, vals):
        s, idx = torch.sort(w, dim=1, stable=True)
        return s, torch.gather(vals, 1, idx)

    ws, wv = lib(biased, v)
    gk, gv = sort_batched(k.view(torch.uint32), v.view(torch.uint32))
    if not (torch.equal(gk.view(torch.int32), common.bias_i32(ws))
            and torch.equal(gv.view(torch.int32), wv)):
        raise AssertionError("sort_batched(keys, values) at 128 rows differs from torch.sort")
    lib_ms = device_time(lib, biased, v) * 1e3
    ms = device_time(sort_batched, k.view(torch.uint32), v.view(torch.uint32)) * 1e3
    report("torch.sort (key, idx, val) stable + gather", N, lib_ms)
    report("sort_batched(keys, values) [128 rows]", N, ms)
    rows.append({"probe": "explore_blocksort library", "rows": b, "row_len": N // b,
                 "values": True, "ms": ms, "torch_sort_ms": lib_ms})
    return rows


def bench(device="cuda", seed=0) -> list[dict]:
    """P2 and P3 on one tile and on 256, P3 also with no stages; each beside
    its plain version's time, its bound and the launch floor (P2 also
    beside a ``copy_`` of its tiles, the time of its bytes), with the
    launch's shape; P2 also in each cluster size the card holds, and P3
    on one tile with each split."""
    dev = interop.resolve_device(device)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    floor = launch_floor_ms(dev)
    floors = {c: launch_floor_ms(dev, c) for c in CE_CLUSTERS if ce_active(c, dev) >= 1}
    x = random_tiles(1, seed, dev)
    out = ce_tiles(x)
    print("sanity kernel ok:", out[0, 0, :3].view(torch.uint32).cpu().numpy(), flush=True)
    print(f"launch floor: {floor:.5f} ms (one block); one cluster, by its blocks: {floors}",
          flush=True)
    rows, inputs = [], {1: x, RATE_TILES: random_tiles(RATE_TILES, seed + 1, dev)}
    for tiles, xt in inputs.items():
        cluster = ce_cluster(tiles, dev)
        ms = device_time(ce_tiles, xt, queued=True) * 1e3
        b_ms, b_by = stage_bound_ms(tiles, 1)
        y = torch.empty_like(xt)
        row = {"probe": "P2", "tiles": tiles, "cluster": cluster, "grid": tiles * cluster,
               "ms": ms, "plain_ms": device_time(ce_plain, xt, iters=3) * 1e3,
               "copy_ms": device_time(y.copy_, xt, queued=True) * 1e3,
               "bound_ms": b_ms, "bound_by": b_by, "launch_floor_ms": floor,
               "cluster_launch_floor_ms": floors[cluster],
               "ms_by_cluster": {c: device_time(lambda a, c=c: ce_tiles(a, c), xt,
                                                queued=True) * 1e3 for c in floors}}
        print(f"P2 ({tiles} tiles, clusters of {cluster}): {ms:.5f} ms, "
              f"{ms / floor:.2f}x the launch floor", flush=True)
        rows.append(row)
    for tiles, xt in inputs.items():
        split = ring_split(tiles, sms)
        ms = device_time(stage_tiles, xt, queued=True) * 1e3
        ms0 = device_time(lambda a: stage_tiles(a, 0), xt, queued=True) * 1e3
        nelem = tiles * ROWS * LANES
        per_stage = ms / NSTAGE
        print(f"compare-exchange stage ({tiles} tiles, rings across {split} lanes): "
              f"{per_stage * 1e3:.3f} us per stage of {nelem} elems -> "
              f"{nelem / per_stage / 1e6:.1f} Gelem/s/stage (0 stages {ms0:.4f} ms; "
              f"{ms / floor:.2f}x the launch floor)", flush=True)
        b_ms, b_by = stage_bound_ms(tiles)
        row = {"probe": "P3", "tiles": tiles, "split": split, "grid": stage_grid(tiles, split),
               "ms": ms, "ms_zero_stages": ms0, "us_per_stage": per_stage * 1e3,
               "gelem_stages_per_s": nelem / per_stage / 1e6,
               "plain_ms": device_time(stages_plain, xt, warmup=1, iters=3) * 1e3,
               "bound_ms": b_ms, "bound_by": b_by, "launch_floor_ms": floor}
        if tiles == 1:
            row["ms_by_split"] = {s: device_time(lambda a, s=s: stage_tiles(a, split=s), xt,
                                                 queued=True) * 1e3 for s in RING_SPLITS}
        rows.append(row)
    return rows


def check(device="cuda", seed=0) -> int:
    """Hold P2 (``CE_CHECK_TILES``, in the default cluster and in each size
    the card holds) and P3 (``STAGE_CHECK_TILES`` at ``CHECK_STAGES``, with
    the host's split and with every split) against their plain versions
    byte for byte; raise on a difference. Returns the largest |difference|
    (0)."""
    dev = interop.resolve_device(device)
    clusters = [c for c in CE_CLUSTERS if ce_active(c, dev) >= 1]
    for tiles in CE_CHECK_TILES:
        x = random_tiles(tiles, seed + tiles, dev)
        want = ce_plain(x)
        for cluster in (None, *clusters):
            if not torch.equal(ce_tiles(x, cluster), want):
                raise AssertionError(f"P2 differs from its plain version on {tiles} tiles "
                                     f"(clusters of {cluster or ce_cluster(tiles, dev)})")
    for tiles in STAGE_CHECK_TILES:
        x = random_tiles(tiles, seed + tiles, dev)
        for n_stages in CHECK_STAGES:
            want = stages_plain(x, n_stages)
            for split in (None, *RING_SPLITS):
                if not torch.equal(stage_tiles(x, n_stages, split), want):
                    raise AssertionError(f"P3 differs from its plain version on {tiles} tiles, "
                                         f"{n_stages} stages, split {split}")
    return 0


def main(device="cuda") -> list[dict]:
    """The library lines, then P2 and P3 timed; a row each."""
    dev = interop.resolve_device(device)
    return library_lines(dev) + bench(dev)


if __name__ == "__main__":
    check()
    main()
