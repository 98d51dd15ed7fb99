"""Probes P4-P7 on the card: where a scan's time goes, beside the copy of
the same bytes.

Counterpart of ``benchmarks/explore_scan.py``. Its values are u32 bit
patterns in int32 (rows, 128) tensors, scanned in row-major element order
with u32 wraparound; `block_rows` is the probe's block of block_rows * 128
elements and must divide the rows (the JAX grid would drop the rest).

- P4 :func:`blocksum_kernel` (``_blocksum_kernel`` :77, launched :92): the
  u32 sum of each block;
- P5 :func:`addback_kernel` (``_addback_kernel`` :82, launched :107): the
  exclusive scan within each block plus that block's offset;
- :func:`twopass_scan` (:89): P4, the exclusive ``torch.cumsum`` of the
  sums masked to 32 bits (outside any kernel, as the probe's ``jnp.cumsum``
  :100), then P5;
- P6 :func:`grid_copy` (``_copy_kernel`` :30, launched :131): a copy, the
  floor of the others;
- P7 :func:`streaming_scan` (``_scan_kernel_and`` :56, launched :145): the
  exclusive scan of the whole array in one pass, its carry chained from
  tile to tile (the probe's AND masks are a TPU formulation, not carried
  over).

Each has a plain PyTorch version (``*_plain``), which a CPU tensor runs; a
CUDA tensor launches ``csrc/explore_scan.cu``. On the card the copy and the
chained scan work in units of their own, so their `block_rows` only has to
divide the rows: the copy is one block an SM, each moving every 132nd
chunk of at most 8 KB through TMA bulk transfers (:func:`copy_flat`); the
chained scan scans tiles of ``CHAIN_TILE`` elements in clusters of
``CHAIN_CLUSTER`` blocks, one link of the chain a cluster
(:func:`chain_layout`). P4 splits a block into chunks of 16,384 elements,
P5 gives each block one CUDA block.

:func:`main` times the probe's cases at 2^24 (P6 at block_rows 512 and
1024, K4 as the "current streaming scan", P7 at 512 and 1024, two-pass at
512, 1024 and 2048, and P4 and P5 alone), each beside its plain version,
one PyTorch call that computes the same function and its bound.

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.explore_scan``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..ops import common, scan
from ..runtime.timing import device_time
from ..utils import interop
from . import HBM_BYTES_PER_S

N = 1 << 24
LANES = 128
COPY_BLOCK_ROWS = (512, 1024)
CHAIN_BLOCK_ROWS = (512, 1024)
TWOPASS_BLOCK_ROWS = (512, 1024, 2048)
CHAIN_TILE = 32768  # elements a tile of the chained scans (kTile in csrc/explore_scan.cu)
CHAIN_CLUSTER = 8  # blocks (tiles) a cluster, one link of the chain (kCluster there)
COPY_CHUNK = 2048  # elements of the copy's largest chunk (kCopyChunkBytes / 4 there)
# The chain's edges that the card's checks cover: tile counts around one
# and two clusters, and 2^24 and one tile more; each case launched REPEATS
# times, so that a race in the chain or the cluster's hand-off shows.
CHAIN_EDGE_TILES = (1, 7, 8, 9, 15, 16, 17, 512, 513)
REPEATS = 50


def _check(x2d: torch.Tensor, block_rows: int) -> None:
    if not isinstance(x2d, torch.Tensor) or x2d.dtype != torch.int32:
        raise TypeError("the scan probes take an int32 tensor of u32 bit patterns")
    if x2d.dim() != 2 or x2d.shape[1] != LANES or x2d.shape[0] == 0 or not x2d.is_contiguous():
        raise ValueError(f"the scan probes take a contiguous (rows, {LANES}) tensor")
    if not isinstance(block_rows, int) or block_rows < 1:
        raise ValueError("block_rows must be a positive int")
    if x2d.shape[0] % block_rows:
        raise ValueError(f"block_rows {block_rows} does not divide the {x2d.shape[0]} rows")
    if x2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x2d.device}")


def _stream(*tensors) -> int:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the scan probes' tensors must start on a 16-byte boundary")
    return torch.cuda.current_stream(tensors[0].device).cuda_stream


def _u64(x: torch.Tensor) -> torch.Tensor:
    """int32 u32 patterns -> their values in int64."""
    return x.to(torch.int64) & 0xFFFFFFFF


def blocksum_plain(x2d: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Plain version of P4: the u32 sum of each block, (rows / block_rows,) int32."""
    _check(x2d, block_rows)
    return scan._wrap_i32(_u64(x2d).reshape(x2d.shape[0] // block_rows, -1).sum(1))


def blocksum_kernel(x2d: torch.Tensor, block_rows: int) -> torch.Tensor:
    """P4: the u32 sum of each block. A CPU tensor runs :func:`blocksum_plain`."""
    _check(x2d, block_rows)
    if x2d.device.type == "cpu":
        return blocksum_plain(x2d, block_rows)
    sums = torch.zeros(x2d.shape[0] // block_rows, dtype=torch.int32, device=x2d.device)
    _build.BLOCKSUM(x2d.data_ptr(), x2d.numel(), block_rows * LANES, sums.data_ptr(),
                    _stream(x2d))
    return sums


def _check_offsets(offs: torch.Tensor, x2d: torch.Tensor, block_rows: int) -> None:
    nb = x2d.shape[0] // block_rows
    if not isinstance(offs, torch.Tensor) or offs.dtype != torch.int32:
        raise TypeError("the block offsets are an int32 tensor of u32 bit patterns")
    if offs.shape != (nb,) or not offs.is_contiguous() or offs.device != x2d.device:
        raise ValueError(f"the block offsets are a contiguous ({nb},) tensor beside the rows")


def addback_plain(offs: torch.Tensor, x2d: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Plain version of P5: each block's exclusive scan plus its offset."""
    _check(x2d, block_rows)
    _check_offsets(offs, x2d, block_rows)
    w = _u64(x2d).reshape(offs.shape[0], -1)
    out = torch.cumsum(w, 1) - w + _u64(offs)[:, None]
    return scan._wrap_i32(out).reshape(x2d.shape)


def addback_kernel(offs: torch.Tensor, x2d: torch.Tensor, block_rows: int) -> torch.Tensor:
    """P5: each block's exclusive scan plus its offset. A CPU tensor runs
    :func:`addback_plain`."""
    _check(x2d, block_rows)
    _check_offsets(offs, x2d, block_rows)
    if x2d.device.type == "cpu":
        return addback_plain(offs, x2d, block_rows)
    out = torch.empty_like(x2d)
    _build.ADDBACK(offs.data_ptr(), x2d.data_ptr(), x2d.numel(), block_rows * LANES,
                   out.data_ptr(), _stream(x2d, out))
    return out


def block_offsets(sums: torch.Tensor) -> torch.Tensor:
    """The exclusive u32 scan of the block sums (the probe's shifted
    ``jnp.cumsum``, :100), by ``torch.cumsum``."""
    return scan.scan_plain(sums)


def twopass_scan(x2d: torch.Tensor, block_rows: int) -> torch.Tensor:
    """The two-pass exclusive scan: P4, the block offsets, P5."""
    return addback_kernel(block_offsets(blocksum_kernel(x2d, block_rows)), x2d, block_rows)


def twopass_plain(x2d: torch.Tensor, block_rows: int) -> torch.Tensor:
    """The two-pass scan through the plain versions of P4 and P5."""
    return addback_plain(block_offsets(blocksum_plain(x2d, block_rows)), x2d, block_rows)


def grid_copy_plain(x2d: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Plain version of P6: a copy."""
    _check(x2d, block_rows)
    return x2d.clone()


def grid_copy(x2d: torch.Tensor, block_rows: int) -> torch.Tensor:
    """P6: a copy of the rows. A CPU tensor runs :func:`grid_copy_plain`."""
    _check(x2d, block_rows)
    if x2d.device.type == "cpu":
        return grid_copy_plain(x2d, block_rows)
    return copy_flat(x2d)


def copy_flat(x: torch.Tensor) -> torch.Tensor:
    """Launch P6 on the contiguous int32 CUDA tensor `x` of any shape, whose
    elements are a positive multiple of 4; a new tensor."""
    if x.dtype != torch.int32 or not x.is_contiguous() or x.numel() < 4 or x.numel() % 4:
        raise ValueError("the copy takes a contiguous int32 tensor of 4k elements, k >= 1")
    out = torch.empty_like(x)
    _build.GRID_COPY(x.data_ptr(), out.data_ptr(), x.numel(), _stream(x, out))
    return out


def streaming_scan_plain(x2d: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Plain version of P7: the exclusive u32 scan of all the rows."""
    _check(x2d, block_rows)
    return scan.scan_plain(x2d.reshape(-1)).reshape(x2d.shape)


def streaming_scan(x2d: torch.Tensor, block_rows: int) -> torch.Tensor:
    """P7: the exclusive u32 scan of all the rows, one pass with the carry
    chained from tile to tile. A CPU tensor runs :func:`streaming_scan_plain`."""
    _check(x2d, block_rows)
    if x2d.device.type == "cpu":
        return streaming_scan_plain(x2d, block_rows)
    return launch_chained(_build.CHAINED_SCAN, x2d)


def chain_layout(n: int) -> tuple[int, int, int, int]:
    """The chained scan's layout for n >= 1 elements: (tiles of
    ``CHAIN_TILE``, clusters of ``CHAIN_CLUSTER`` tiles, the grid's blocks
    (whole clusters: the last one's surplus blocks hold no elements), the
    scratch's 64-bit words (a flag a cluster, and the ticket))."""
    if n < 1:
        raise ValueError("the chained scan takes n >= 1 elements")
    tiles = common.cdiv(n, CHAIN_TILE)
    clusters = common.cdiv(tiles, CHAIN_CLUSTER)
    return tiles, clusters, clusters * CHAIN_CLUSTER, clusters + 1


def launch_chained(kernel: _build.Kernel, x: torch.Tensor) -> torch.Tensor:
    """Launch a chained scan of ``csrc/explore_scan.cu`` (P7, or P8's max)
    over the contiguous CUDA tensor `x`; a new tensor."""
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        # the clusters' flags and the ticket, zeroed on the stream
        scratch = torch.zeros(chain_layout(n)[3], dtype=torch.int64, device=x.device)
        kernel(x.data_ptr(), n, out.data_ptr(), scratch.data_ptr(),
               torch.cuda.current_stream(x.device).cuda_stream)
    return out


def chain_clusters() -> tuple[int, int]:
    """(blocks a cluster of the chained scan, the clusters that the current
    CUDA device holds at once), from ``cudaOccupancyMaxActiveClusters``."""
    lib = _build.library("explore_scan")
    cluster, active = ctypes.c_int(), ctypes.c_int()
    err = lib.trs_chain_clusters(ctypes.byref(cluster), ctypes.byref(active))
    if err:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {err} "
                           f"({lib.trs_error_string(err).decode()})")
    return cluster.value, active.value


def chain_edge_inputs(tiles: int, values, device) -> list[tuple[str, torch.Tensor]]:
    """The chain's edge cases at `tiles` tiles, 1-D int32 from
    ``values(n, seed)`` (a numpy array): whole tiles (the 16-byte path); a
    partial last tile whose n is not a multiple of 4; and a view one
    element into its storage (the scalar path throughout)."""
    n = tiles * CHAIN_TILE

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)

    return [("whole tiles", dev(values(n, tiles))),
            ("partial, n % 4 = 3", dev(values(n - 5, tiles + 1))),
            ("a view one element in", dev(values(n + 1, tiles + 2))[1:])]


def full_range_u32(n: int, seed: int) -> np.ndarray:
    """`n` full-range u32 draws from `seed`."""
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def check_repeated(fn, x: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Run fn(x) ``REPEATS`` times on one stream; raise unless every result
    equals `want` byte for byte."""
    for r in range(REPEATS):
        if not torch.equal(fn(x), want):
            raise AssertionError(f"{what} differs from its plain version at launch {r + 1}")


def copy_edge_sizes(sms: int) -> tuple[int, ...]:
    """P6's edges on a card of `sms` SMs (one block each): one vector; a
    chunk and a vector; a chunk and a vector for every SM; 30 chunks an SM
    and 7 more, so that each block's chunks run past the ring of stages and
    the last chunk is short; 2^24 + 4."""
    return (4, COPY_CHUNK + 4, sms * (COPY_CHUNK + 4), (30 * sms + 7) * COPY_CHUNK + 4,
            N + 4)


def probe_input(device, seed: int = 0, n: int = N) -> torch.Tensor:
    """The probe's values (:125-127): `n` draws of 0..7, as (n / 128, 128) int32."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 8, n, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device).view(-1, LANES)


def random_rows(rows: int, seed: int, device) -> torch.Tensor:
    """Full-range u32 patterns, so that every sum wraps."""
    x = full_range_u32(rows * LANES, seed).reshape(rows, LANES)
    return torch.from_numpy(x.view(np.int32)).to(device)


def _row(probe, block_rows, fn, plain, library, x, n_bytes, *args):
    ms = device_time(fn, *args, queued=True) * 1e3
    row = {"probe": probe, "block_rows": block_rows, "n": x.numel(), "ms": ms,
           "plain_ms": device_time(plain, *args, warmup=1, iters=3) * 1e3,
           "library_ms": device_time(library, x, queued=True) * 1e3,
           "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
           "gb_per_s": n_bytes / ms / 1e6}
    print(f"{probe:8s} block {block_rows!s:5s} {ms:8.4f} ms  {row['gb_per_s']:7.1f} GB/s  "
          f"library {row['library_ms']:8.4f} ms  bound {row['bound_ms']:.4f} ms", flush=True)
    return row


def main(device="cuda", seed=0) -> list[dict]:
    """Time the probe's cases at 2^24 on its values; a row each. The bytes
    of the bound: each input read once and each output written once."""
    dev = interop.resolve_device(device)
    x2d = probe_input(dev, seed)
    flat = x2d.view(-1)
    n = flat.numel()
    y = torch.empty_like(x2d)

    def cumsum(x):  # one torch call: the inclusive scan (the exclusive one is it minus x)
        return torch.cumsum(x.view(-1), 0, dtype=torch.int32)

    rows = []
    for br in COPY_BLOCK_ROWS:
        rows.append(_row("P6", br, grid_copy, grid_copy_plain, lambda x: y.copy_(x), x2d,
                         8 * n, x2d, br))
    rows.append(_row("K4", None, scan.scan_kernel, scan.scan_plain, cumsum, flat, 8 * n, flat))
    for br in CHAIN_BLOCK_ROWS:
        rows.append(_row("P7", br, streaming_scan, streaming_scan_plain, cumsum, x2d, 8 * n,
                         x2d, br))
    for br in TWOPASS_BLOCK_ROWS:
        nb = x2d.shape[0] // br
        rows.append(_row("two-pass", br, twopass_scan, twopass_plain, cumsum, x2d, 8 * n,
                         x2d, br))
        rows.append(_row("P4", br, blocksum_kernel, blocksum_plain,
                         lambda x, nb=nb: x.view(nb, -1).sum(1), x2d, 4 * n + 4 * nb, x2d, br))
        offs = block_offsets(blocksum_kernel(x2d, br))
        rows.append(_row("P5", br, addback_kernel, addback_plain, cumsum, x2d,
                         8 * n + 4 * nb, offs, x2d, br))
    return rows


def check(device="cuda", seed=0) -> int:
    """Hold every kernel against its plain version, byte for byte, on
    full-range u32 and on the probe's values: one block, two, many, block
    sizes whose last CUDA chunk or tile is partial, and 2^24 (64 chained
    clusters); then the chain's edges (:func:`chain_edge_inputs` at each of
    ``CHAIN_EDGE_TILES``, full-range u32) and the copy's
    (:func:`copy_edge_sizes`), each launched ``REPEATS`` times; raise on a
    difference. Returns the largest |difference| (0)."""
    dev = interop.resolve_device(device)
    cases = [(1, 1), (8, 1), (16, 2), (8, 37), (24, 37), (512, 3), (512, N // LANES // 512)]
    for i, (br, nb) in enumerate(cases):
        inputs = [random_rows(br * nb, seed + i, dev), probe_input(dev, seed + i, br * nb * LANES)]
        for x2d in inputs:
            offs = block_offsets(blocksum_plain(x2d, br))
            for name, got, want in (
                    ("P4", blocksum_kernel(x2d, br), blocksum_plain(x2d, br)),
                    ("P5", addback_kernel(offs, x2d, br), addback_plain(offs, x2d, br)),
                    ("two-pass", twopass_scan(x2d, br), streaming_scan_plain(x2d, br)),
                    ("P6", grid_copy(x2d, br), x2d),
                    ("P7", streaming_scan(x2d, br), streaming_scan_plain(x2d, br))):
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} differs from its plain version at "
                                         f"{nb} blocks of {br} rows")
    for tiles in CHAIN_EDGE_TILES:
        for label, x in chain_edge_inputs(tiles, full_range_u32, dev):
            check_repeated(lambda a: launch_chained(_build.CHAINED_SCAN, a), x,
                           scan.scan_plain(x), f"P7 at {tiles} tiles ({label})")
    for n in copy_edge_sizes(torch.cuda.get_device_properties(dev).multi_processor_count):
        x = torch.from_numpy(full_range_u32(n, n).view(np.int32)).to(dev)
        check_repeated(copy_flat, x, x, f"P6 at n = {n}")
    return 0


if __name__ == "__main__":
    check()
    main()
