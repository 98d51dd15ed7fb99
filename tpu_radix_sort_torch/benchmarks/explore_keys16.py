"""Probes P8 and P9 on the card: the 16-bit keys-only counting sort with its
running-max emission, and the min/max stage rate per lane type.

Counterpart of ``benchmarks/explore_keys16.py``.

**P8** (``cummax_1d`` :80, kernel body ``_cummax_kernel`` :45): the
inclusive running max of int32 with identity 0 (the probe's pads, shifts
and carry bring in 0), so the result is max(0, cummax(x)) for any input.
:func:`cummax_plain` computes it in PyTorch; :func:`cummax_1d` launches the
chained scan of ``csrc/explore_scan.cu`` with max on a CUDA tensor (its
`block_rows` sets only the probe's zero padding, which changes no result,
so the card ignores it). It is the emission step of the keys-only counting
sorts (:90-140): a 65,536-bin histogram, by ``index_add_``
(:func:`counting_sort_u16`) or by one-hot float32 products per block of
2^19 keys (:func:`matmul_hist_u16`, ``torch.matmul``, as the JAX package
left the product to XLA: exact, counts stay below 2^24), its exclusive
scan, a scatter of each run's value + 1 to its start (empty runs to a
dropped slot n), :func:`cummax_1d`, minus 1. The JAX probe kept the
scatter histogram behind a flag (a TPU compiler dead end); the port runs
it.

**P9** (``stage_rate`` :163, kernel body ``_stage_kernel`` :144): over rows
of 128 elements (32,768 rows), `reps` times, s = 1 + (r & 3), p[:, l] =
x[:, (l - s) mod 128] and x <- min(x, p) at even lanes l, max(x, p) at odd
ones; for int32, uint16, int16 and bfloat16. :func:`stage_plain` computes
it in PyTorch; :func:`stage_kernel` launches ``csrc/explore_keys16.cu`` on
a CUDA tensor (one row a thread in registers; uint16 and int16 rows as
packed pairs, bfloat16 rows widened to one 32-bit code an element).

bfloat16 matches what the JAX package computes on the CPU: subnormals
count as zero of their sign, -0 < +0, and a NaN operand gives 0x7FC0 or
0xFFC0 (the minimum is 0xFFC0 only if every NaN operand is negative, the
maximum 0x7FC0 only if every one is positive). The kernel runs that rule
as a signed minimum and an unsigned maximum of the code
:func:`_bf16_code`; the plain version states the rule itself
(:func:`_bf16_min_max`). uint16 patterns ride in int32 in the plain
version, as the port's u32 patterns do (torch has no uint16 ``minimum``
on the CPU). Where the JAX probe feeds zeros, this one feeds seeded random
rows (:func:`random_rows`) and every 16-bit pattern beside the values the
lane types disagree on (:func:`all_pattern_rows`), checked against the
plain version, at the probe's reps = 16 and at reps = 256, where the ALU,
not the bytes, sets the time.

:func:`main` runs the probe's sort lines at 2^24 u16 keys (the bitonic
engine, ``method='radix'``, ``method='xla'``, both counting sorts, and the
Zipf(1.3) pair), each byte-checked against ``torch.sort``, times
:func:`cummax_1d` alone beside ``torch.cummax``, then the P9 rates.

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.explore_keys16``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..runtime.timing import device_time
from ..utils import interop
from . import ALU_OPS_PER_S, HBM_BYTES_PER_S
from .explore_scan import (CHAIN_EDGE_TILES, CHAIN_TILE, chain_edge_inputs,
                           check_repeated, launch_chained)

TOTAL_ROWS = 1 << 15
LANES = 128
REPS = 16
RATE_REPS = (REPS, 256)
ALL_PATTERN_REPS = (1, 2, 7, 256)  # the card's check on all_pattern_rows
DTYPES = (torch.int32, torch.uint16, torch.int16, torch.bfloat16)
N16 = 1 << 24  # keys of the probe's sort lines
CUMMAX_BLOCK_ROWS = 512
HIST_BLOCK = 1 << 19  # keys a one-hot product of matmul_hist_u16
BINS = 1 << 16


def _check(x: torch.Tensor, reps: int) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype not in DTYPES:
        raise TypeError(f"stage rows take one of {DTYPES}")
    if x.dim() != 2 or x.shape[1] != LANES or x.shape[0] == 0 or not x.is_contiguous():
        raise ValueError(f"stage rows take a contiguous (rows, {LANES}) tensor")
    if reps < 0:
        raise ValueError("reps must be >= 0")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _bf16_canonical(w: torch.Tensor) -> torch.Tensor:
    """bfloat16 patterns (in int32): subnormals to zero of their sign, NaN
    to 0x7FC0 or 0xFFC0 by its sign."""
    sign = w & 0x8000
    w = torch.where((w & 0x7F80) == 0, sign, w)
    return torch.where((w & 0x7FFF) > 0x7F80, sign | 0x7FC0, w)


def _bf16_min_max(x: torch.Tensor, p: torch.Tensor):
    """The JAX package's bfloat16 minimum and maximum of canonical patterns."""
    def key(v):  # -0 < +0: a bijection onto the order of the values
        return torch.where((v & 0x8000) != 0, -(v & 0x7FFF) - 1, v & 0x7FFF)

    kx, kp = key(x), key(p)
    nx, np_ = (x & 0x7FFF) > 0x7F80, (p & 0x7FFF) > 0x7F80
    pos_nan = (nx & ((x & 0x8000) == 0)) | (np_ & ((p & 0x8000) == 0))
    neg_nan = (nx & ((x & 0x8000) != 0)) | (np_ & ((p & 0x8000) != 0))
    lo = torch.where(kx <= kp, x, p)
    hi = torch.where(kx >= kp, x, p)
    lo = torch.where(pos_nan, 0x7FC0, torch.where(neg_nan, 0xFFC0, lo))
    hi = torch.where(neg_nan, 0xFFC0, torch.where(pos_nan, 0x7FC0, hi))
    return lo, hi


def _bf16_code(w: torch.Tensor) -> torch.Tensor:
    """The stage kernel's 32-bit code of canonical bfloat16 patterns (in
    int32): +NaN 0x80000000, -NaN 0x80000001, a number x its total-order
    code x ^ (0xFFFF if negative else 0x8000), 0..0xFFFF. The signed
    minimum and the unsigned maximum of two codes are the codes of
    :func:`_bf16_min_max`. A mirror of ``csrc/explore_keys16.cu``
    ``bf16_code`` for the CPU tests; no path on the card uses it."""
    sign = w >> 15
    flip = torch.where(sign == 1, 0xFFFF, 0x8000).to(torch.int32)
    return torch.where((w & 0x7FFF) > 0x7F80, sign - 2**31, w ^ flip)


def _bf16_decode(c: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_bf16_code` (``csrc/explore_keys16.cu``
    ``bf16_decode``): int32 codes -> the patterns in int32."""
    flip = torch.where((c & 0x8000) != 0, 0x8000, 0xFFFF).to(torch.int32)
    return torch.where(c < 0, 0x7FC0 | ((c & 1) << 15), c ^ flip)


def stage_plain(x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """Plain version of P9: `reps` stages on the (rows, 128) tensor."""
    _check(x, reps)
    dt = x.dtype
    if dt == torch.int32:
        w = x.clone()
    elif dt == torch.int16:
        w = x.to(torch.int32)
    else:  # the u16 pattern, zero-extended
        w = x.view(torch.int16).to(torch.int32) & 0xFFFF
    if dt == torch.bfloat16 and reps > 0:
        w = _bf16_canonical(w)
    even = (torch.arange(LANES, device=x.device) & 1) == 0
    for r in range(reps):
        p = torch.roll(w, 1 + (r & 3), dims=1)
        if dt == torch.bfloat16:
            lo, hi = _bf16_min_max(w, p)
        else:
            lo, hi = torch.minimum(w, p), torch.maximum(w, p)
        w = torch.where(even, lo, hi)
    if dt == torch.int32:
        return w
    w16 = w.to(torch.int16)
    return w16 if dt == torch.int16 else w16.view(dt)


_KIND = {torch.int32: 0, torch.uint16: 1, torch.int16: 2, torch.bfloat16: 3}


def stage_kernel(x: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """P9's kernel: `reps` stages on the (rows, 128) tensor; a new tensor.
    A CPU tensor runs :func:`stage_plain`."""
    _check(x, reps)
    if x.device.type == "cpu":
        return stage_plain(x, reps)
    if x.data_ptr() % 16:
        raise ValueError("stage rows must start on a 16-byte boundary")
    out = torch.empty_like(x)
    _build.KEYS16_STAGE(x.data_ptr(), out.data_ptr(), x.shape[0], reps, _KIND[x.dtype],
                        torch.cuda.current_stream(x.device).cuda_stream)
    return out


# The 16-bit values the lane types disagree on: NaNs of both signs and
# payloads, subnormals, -0.0 and +0.0, infinities.
SPECIALS = np.array([0x7FC0, 0xFFC0, 0x7F81, 0xFF81, 0x7FFF, 0x0000, 0x8000, 0x0001,
                     0x8001, 0x007F, 0x7F80, 0xFF80, 0x3F80, 0xBF80, 0x7FEF, 0xFFFF], np.uint16)


def random_rows(dtype, rows: int, seed: int, device) -> torch.Tensor:
    """Seeded random rows of `dtype` (16-bit ones as random patterns), with
    :data:`SPECIALS` in the first rows."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        u = rng.integers(-2**31, 2**31, (rows, LANES), dtype=np.int64).astype(np.int32)
        return torch.from_numpy(u).to(device)
    u = rng.integers(0, 2**16, (rows, LANES), dtype=np.int64).astype(np.uint16)
    u[: min(rows, 64)] = rng.choice(SPECIALS, (min(rows, 64), LANES))
    return torch.from_numpy(u.view(np.int16)).to(device).view(dtype)


def all_pattern_rows(dtype, device) -> torch.Tensor:
    """1,024 rows that hold every 16-bit pattern once, in order, at the odd
    lanes, each beside one of :data:`SPECIALS` at the even lane before it
    (the specials cycling): at reps 1 every pattern meets a special in the
    maximum and another in the minimum. int32 rows hold the patterns as
    int16 values, sign-extended."""
    u = np.empty((1 << 16) * 2, np.uint16)
    u[1::2] = np.arange(1 << 16, dtype=np.uint16)
    u[0::2] = np.resize(SPECIALS, 1 << 16)
    x = torch.from_numpy(u.view(np.int16).reshape(-1, LANES)).to(device)
    return x.to(torch.int32) if dtype == torch.int32 else x.view(dtype)


def stage_ops(dtype, reps: int, n_el: int) -> int:
    """Operations on the card's 32-bit integer lanes that `reps` stages over
    n_el elements need, for every lane type: one minimum or maximum an
    element a stage (int32 one a lane, bfloat16 one a lane on its 32-bit
    code; uint16 and int16 a packed minimum and a packed maximum a word of
    two elements). The stage kernel issues more for uint16 and int16 (SASS,
    `kernel_times.py --sass`): a byte permute that merges the two results a
    word, and one more where the roll s = 1 + (r & 3) is odd (the partner
    pair then straddles two words), 7/4 an element a stage; bfloat16 adds
    its encoding at the load and decoding at the store, once a row. Those
    are the formulation's cost, not the function's, and are not counted."""
    return reps * n_el


def stage_rate(dtype, reps: int = REPS, *, device="cuda", seed: int = 0) -> dict:
    """Element-stages a second through `reps` stages of the dtype over
    32,768 rows (the kernel's calls queued, so that their launch hides)."""
    dev = interop.resolve_device(device)
    x = random_rows(dtype, TOTAL_ROWS, seed, dev)
    ms = device_time(stage_kernel, x, reps, queued=True) * 1e3
    n_el = TOTAL_ROWS * LANES
    name = str(dtype).removeprefix("torch.")
    bytes_ms = 2 * x.element_size() * n_el / HBM_BYTES_PER_S * 1e3
    ops_ms = stage_ops(dtype, reps, n_el) / ALU_OPS_PER_S * 1e3
    row = {"probe": "P9", "dtype": name, "reps": reps, "ms": ms,
           "gelem_stages_per_s": n_el * reps / ms / 1e6,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "plain_ms": device_time(stage_plain, x, reps, warmup=1, iters=3) * 1e3}
    print(f"stage rate {name:8s}: {row['gelem_stages_per_s']:7.2f} Gelem-stages/s "
          f"({ms:.4f} ms / {reps} stages of {n_el >> 20}M)", flush=True)
    return row


# ---- P8: the running max and the counting sorts built on it -----------------
def _check_cummax(x: torch.Tensor, block_rows: int) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError("cummax_1d takes an int32 tensor")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError("cummax_1d takes one contiguous 1-D tensor")
    if not isinstance(block_rows, int) or block_rows < 1:
        raise ValueError("block_rows must be a positive int")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def cummax_plain(x: torch.Tensor, block_rows: int = CUMMAX_BLOCK_ROWS) -> torch.Tensor:
    """Plain version of P8: max(0, the inclusive running max of x)."""
    _check_cummax(x, block_rows)
    if x.numel() == 0:
        return x.clone()
    return torch.cummax(x, 0).values.clamp_min(0)


def cummax_1d(x: torch.Tensor, block_rows: int = CUMMAX_BLOCK_ROWS) -> torch.Tensor:
    """P8: max(0, the inclusive running max of the int32 x), a new tensor.
    A CPU tensor runs :func:`cummax_plain`."""
    _check_cummax(x, block_rows)
    if x.device.type == "cpu":
        return cummax_plain(x, block_rows)
    return launch_chained(_build.CUMMAX, x)


def _keys_i32(k16: torch.Tensor) -> torch.Tensor:
    """uint16 keys -> their values in int32."""
    if not isinstance(k16, torch.Tensor) or k16.dtype != torch.uint16:
        raise TypeError("the counting sorts take uint16 keys")
    if k16.dim() != 1 or not k16.is_contiguous():
        raise ValueError("the counting sorts take one contiguous 1-D tensor")
    if k16.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {k16.device}")
    return k16.view(torch.int16).to(torch.int32) & 0xFFFF


def scatter_hist_u16(k16: torch.Tensor) -> torch.Tensor:
    """The 65,536-bin int32 histogram of the keys, by ``index_add_``."""
    k = _keys_i32(k16)
    return torch.zeros(BINS, dtype=torch.int32, device=k.device).index_add_(
        0, k, torch.ones_like(k))


def matmul_hist_u16(k16: torch.Tensor, blk: int = HIST_BLOCK) -> torch.Tensor:
    """The histogram as hist[hi8, lo8], summed over blocks of `blk` keys of
    one-hot float32 products (exact: counts stay below 2^24)."""
    k = _keys_i32(k16)
    n = k.numel()
    blk = min(blk, n)
    if blk == 0 or n % blk:
        raise ValueError(f"matmul_hist_u16 takes a positive multiple of {blk} keys")
    ids = torch.arange(256, dtype=torch.int32, device=k.device)
    acc = torch.zeros((256, 256), dtype=torch.int32, device=k.device)
    for kb in k.view(n // blk, blk):
        hi = ((kb >> 8)[:, None] == ids).to(torch.float32)
        lo = ((kb & 255)[:, None] == ids).to(torch.float32)
        acc += torch.matmul(hi.T, lo).to(torch.int32)
    return acc.reshape(BINS)


def run_starts(hist: torch.Tensor, n: int) -> torch.Tensor:
    """(value + 1) at the start of each non-empty run of the sorted keys, 0
    elsewhere, (n,) int32: empty runs go to slot n, which is dropped."""
    csum = torch.cumsum(hist, 0, dtype=torch.int64) - hist
    pos = torch.where(hist > 0, csum, n)
    vals = torch.arange(1, BINS + 1, dtype=torch.int32, device=hist.device)
    starts = torch.zeros(n + 1, dtype=torch.int32, device=hist.device)
    return starts.scatter_reduce_(0, pos, vals, "amax")[:n]


def _emit(hist: torch.Tensor, n: int) -> torch.Tensor:
    return (cummax_1d(run_starts(hist, n)) - 1).to(torch.int16).view(torch.uint16)


def counting_sort_u16(k16: torch.Tensor) -> torch.Tensor:
    """Keys-only counting sort of uint16 keys, the histogram by
    ``index_add_``; the sorted keys as uint16."""
    return _emit(scatter_hist_u16(k16), k16.numel())


def counting_sort_u16_matmul(k16: torch.Tensor) -> torch.Tensor:
    """Keys-only counting sort of uint16 keys, the histogram by one-hot
    products; the sorted keys as uint16."""
    return _emit(matmul_hist_u16(k16), k16.numel())


def cummax_inputs(n: int, seed: int, device) -> list[torch.Tensor]:
    """Full-range int32; a :func:`rising_walk` from below zero (each tile
    adds to the carry it gets); all negative; the run starts of a counting
    sort."""
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, 2**16, n).astype(np.uint16).view(np.int16))
    hist = scatter_hist_u16(keys.view(torch.uint16))
    arrays = [rng.integers(-2**31, 2**31, n).astype(np.int32), rising_walk(n, seed),
              rng.integers(-2**31, 0, n).astype(np.int32)]
    return [torch.from_numpy(a).to(device) for a in arrays] + [run_starts(hist, n).to(device)]


def rising_walk(n: int, seed: int) -> np.ndarray:
    """int32 rising by 61 an element from -2^20, with noise of +-5,000: past
    the first half tile, each tile's running max starts from the carry it
    is given."""
    rng = np.random.default_rng(seed)
    walk = np.arange(n, dtype=np.int64) * 61 - (1 << 20) + rng.integers(-5000, 5000, n)
    return np.clip(walk, -2**31, 2**31 - 1).astype(np.int32)


def sort_lines(device="cuda", seed=0) -> list[dict]:
    """The probe's sort lines at 2^24 u16 keys (:192-226), each byte-checked
    against ``torch.sort`` of the keys widened to int32 (raises on a
    difference); then :func:`cummax_1d` alone on the run starts of the
    uniform keys, beside ``torch.cummax``."""
    from ..ops.sort import sort

    dev = interop.resolve_device(device)
    rng = np.random.default_rng(seed)
    uniform = rng.integers(0, 2**16, N16).astype(np.uint16)
    zipf = np.minimum(rng.zipf(1.3, N16), 2**16 - 1).astype(np.uint16)
    cases = (("bitonic widened (default)", "uniform", sort),
             ("radix bit_count=16 (8 passes)", "uniform", lambda a: sort(a, method="radix")),
             ("torch.sort (method='xla')", "uniform", lambda a: sort(a, method="xla")),
             ("counting (scatter hist + cummax)", "uniform", counting_sort_u16),
             ("counting (matmul hist + cummax)", "uniform", counting_sort_u16_matmul),
             ("Zipf bitonic widened", "zipf", sort),
             ("Zipf counting (matmul hist)", "zipf", counting_sort_u16_matmul))
    keys, want, library_ms = {}, {}, {}
    for name, k in (("uniform", uniform), ("zipf", zipf)):
        keys[name] = torch.from_numpy(k.view(np.int16)).to(dev).view(torch.uint16)
        wide = keys[name].view(torch.int16).to(torch.int32) & 0xFFFF
        want[name] = torch.sort(wide).values.to(torch.int16)
        library_ms[name] = device_time(torch.sort, wide, warmup=1, iters=5) * 1e3
    rows = []
    for name, dist, fn in cases:
        if not torch.equal(fn(keys[dist]).view(torch.int16), want[dist]):
            raise AssertionError(f"P8 sort line {name!r} differs from torch.sort")
        ms = device_time(fn, keys[dist], warmup=1, iters=3) * 1e3
        rows.append({"probe": "P8", "case": name, "keys": dist, "n": N16, "ms": ms,
                     "library_ms": library_ms[dist], "library": "torch.sort of the int32 keys",
                     "bound_ms": 2 * 2 * N16 / HBM_BYTES_PER_S * 1e3, "ok": True})
        print(f"{N16 >> 20}M u16 {name:36s} {ms:9.3f} ms  {N16 / ms / 1e6:7.3f} Gkeys/s  "
              f"torch.sort {library_ms[dist]:.3f} ms  ok", flush=True)
    starts = run_starts(scatter_hist_u16(keys["uniform"]), N16)
    ms = device_time(cummax_1d, starts, queued=True) * 1e3
    rows.append({"probe": "P8", "case": "cummax_1d", "block_rows": CUMMAX_BLOCK_ROWS, "n": N16,
                 "ms": ms, "plain_ms": device_time(cummax_plain, starts, warmup=1, iters=3) * 1e3,
                 "library_ms": device_time(lambda x: torch.cummax(x, 0), starts,
                                           queued=True) * 1e3,
                 "library": "torch.cummax", "bound_ms": 2 * 4 * N16 / HBM_BYTES_PER_S * 1e3})
    print(f"cummax_1d {N16 >> 20}M {ms:.4f} ms  torch.cummax {rows[-1]['library_ms']:.4f} ms",
          flush=True)
    return rows


def check(device="cuda", seed=0) -> int:
    """Hold P9 against :func:`stage_plain`, every dtype at reps 0, 1, 16,
    256 and an odd count on :func:`random_rows`, and at reps 1, 2, 7 and
    256 on :func:`all_pattern_rows`; and P8 against :func:`cummax_plain` on
    :func:`cummax_inputs` of one element to 2^24 (a partial last tile, one
    whole tile and one more element among them) and on the chain's edges
    (``explore_scan.chain_edge_inputs`` at each of ``CHAIN_EDGE_TILES``, a
    :func:`rising_walk`, each launched ``REPEATS`` times), byte for byte;
    raise on a difference. Returns the largest |difference| (0)."""
    dev = interop.resolve_device(device)
    for dtype in DTYPES:
        x = random_rows(dtype, TOTAL_ROWS, seed, dev)
        view = torch.int32 if dtype == torch.int32 else torch.int16
        for reps in (0, 1, 7, *RATE_REPS):
            if not torch.equal(stage_kernel(x, reps).view(view), stage_plain(x, reps).view(view)):
                raise AssertionError(f"P9 {dtype} differs from its plain version at reps {reps}")
        x = all_pattern_rows(dtype, dev)
        for reps in ALL_PATTERN_REPS:
            if not torch.equal(stage_kernel(x, reps).view(view), stage_plain(x, reps).view(view)):
                raise AssertionError(f"P9 {dtype} differs from its plain version on every "
                                     f"pattern at reps {reps}")
    for n in (1, 5000, CHAIN_TILE, CHAIN_TILE + 1, 100_003, N16):
        for x in cummax_inputs(n, seed + n, dev):
            if not torch.equal(cummax_1d(x), cummax_plain(x)):
                raise AssertionError(f"P8 differs from its plain version at n = {n}")
    for tiles in CHAIN_EDGE_TILES:
        for label, x in chain_edge_inputs(tiles, rising_walk, dev):
            check_repeated(cummax_1d, x, cummax_plain(x), f"P8 at {tiles} tiles ({label})")
    return 0


def main(device="cuda") -> list[dict]:
    """The sort lines and cummax_1d (:func:`sort_lines`), then every P9
    dtype at each of RATE_REPS; a row each."""
    dev = interop.resolve_device(device)
    return sort_lines(dev) + [stage_rate(dt, reps, device=dev) for dt in DTYPES
                              for reps in RATE_REPS]


if __name__ == "__main__":
    check()
    main()
