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

A single tile cannot fill the card, so the kernels (``csrc/
explore_blocksort.cu``) apply the per-tile function to B independent
tiles: B = 1 for the probe's check and B = 256 (2^24 elements) for a rate.
Tiles are int32 tensors of u32 patterns, (B, 512, 128) or (512, 128).

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.explore_blocksort``.
"""
from __future__ import annotations

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


def stage_bound_ms(tiles: int, n_stages: int = NSTAGE) -> tuple[float, str]:
    """P3's least time on the card: its tiles read once and written once,
    or its stages' integer operations, whichever is longer; and which."""
    t_bytes = tiles * 2 * 4 * ROWS * LANES / HBM_BYTES_PER_S * 1e3
    t_ops = tiles * ROWS * LANES * n_stages * ALU_OPS_PER_ELEMENT / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def ce_tiles(x: torch.Tensor) -> torch.Tensor:
    """P2's kernel on each tile. A CPU tensor runs :func:`ce_plain`."""
    t = _tiles(x)
    if t.device.type == "cpu":
        return ce_plain(x)
    out = torch.empty_like(t)
    _build.BLOCKSORT_CE(t.data_ptr(), out.data_ptr(), t.shape[0], _stream(t))
    return out.view(x.shape)


def stage_tiles(x: torch.Tensor, n_stages: int = NSTAGE) -> torch.Tensor:
    """P3's kernel: `n_stages` stages on each tile, resident in registers.
    A CPU tensor runs :func:`stages_plain`."""
    t = _tiles(x)
    if n_stages < 0:
        raise ValueError("n_stages must be >= 0")
    if t.device.type == "cpu":
        return stages_plain(x, n_stages)
    out = torch.empty_like(t)
    _build.BLOCKSORT_STAGES(t.data_ptr(), out.data_ptr(), t.shape[0], n_stages, _stream(t))
    return out.view(x.shape)


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
    """P2 on one tile; P3 on one tile and on 256, with its 0-stage time;
    each beside its plain version's time and its bound."""
    dev = interop.resolve_device(device)
    x = random_tiles(1, seed, dev)
    out = ce_tiles(x)
    print("sanity kernel ok:", out[0, 0, :3].view(torch.uint32).cpu().numpy(), flush=True)
    tile_bytes = 2 * 4 * ROWS * LANES
    rows = [{"probe": "P2", "tiles": 1,
             "ms": device_time(ce_tiles, x, queued=True) * 1e3,
             "plain_ms": device_time(ce_plain, x, iters=3) * 1e3,
             "bound_ms": tile_bytes / HBM_BYTES_PER_S * 1e3}]
    for tiles in (1, RATE_TILES):
        xt = x if tiles == 1 else random_tiles(tiles, seed + 1, dev)
        ms = device_time(stage_tiles, xt, queued=True) * 1e3
        ms0 = device_time(lambda a: stage_tiles(a, 0), xt, queued=True) * 1e3
        nelem = tiles * ROWS * LANES
        per_stage = ms / NSTAGE
        print(f"compare-exchange stage ({tiles} tiles): {per_stage * 1e3:.3f} us per stage of "
              f"{nelem} elems -> {nelem / per_stage / 1e6:.1f} Gelem/s/stage "
              f"(0 stages {ms0:.4f} ms)", flush=True)
        b_ms, b_by = stage_bound_ms(tiles)
        rows.append({"probe": "P3", "tiles": tiles, "ms": ms, "ms_zero_stages": ms0,
                     "us_per_stage": per_stage * 1e3,
                     "gelem_stages_per_s": nelem / per_stage / 1e6,
                     "plain_ms": device_time(stages_plain, xt, warmup=1, iters=3) * 1e3,
                     "bound_ms": b_ms, "bound_by": b_by})
    return rows


def check(device="cuda", seed=0) -> int:
    """Hold P2 (one tile, and 3) and P3 (one tile, 256, and 0 stages)
    against their plain versions byte for byte; raise on a difference.
    Returns the largest |difference| (0)."""
    dev = interop.resolve_device(device)
    for tiles in (1, 3):
        x = random_tiles(tiles, seed + tiles, dev)
        if not torch.equal(ce_tiles(x), ce_plain(x)):
            raise AssertionError(f"P2 differs from its plain version on {tiles} tiles")
    for tiles, n_stages in ((1, NSTAGE), (RATE_TILES, NSTAGE), (RATE_TILES, 0)):
        x = random_tiles(tiles, seed + tiles, dev)
        if not torch.equal(stage_tiles(x, n_stages), stages_plain(x, n_stages)):
            raise AssertionError(f"P3 differs from its plain version on {tiles} tiles, "
                                 f"{n_stages} stages")
    return 0


def main(device="cuda") -> list[dict]:
    """The library lines, then P2 and P3 timed; a row each."""
    dev = interop.resolve_device(device)
    return library_lines(dev) + bench(dev)


if __name__ == "__main__":
    check()
    main()
