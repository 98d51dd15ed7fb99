"""Probe P9 on the card: the min/max stage rate per lane type. Does a 16-bit
lane, two to a register, run at twice the int32 element rate?

Counterpart of ``benchmarks/explore_keys16.py:163`` ``stage_rate`` (kernel
body ``_stage_kernel`` :144): over rows of 128 elements (32,768 rows),
`reps` times, s = 1 + (r & 3), p[:, l] = x[:, (l - s) mod 128] and
x <- min(x, p) at even lanes l, max(x, p) at odd ones; for int32, uint16,
int16 and bfloat16. :func:`stage_plain` computes it in PyTorch;
:func:`stage_kernel` launches ``csrc/explore_keys16.cu`` on a CUDA tensor
(one row a thread in registers; 16-bit rows as packed pairs).

bfloat16 matches what the JAX package computes on the CPU: subnormals
count as zero of their sign, -0 < +0, and a NaN operand gives 0x7FC0 or
0xFFC0 (the minimum is 0xFFC0 only if every NaN operand is negative, the
maximum 0x7FC0 only if every one is positive). uint16 patterns ride in
int32 in the plain version, as the port's u32 patterns do (torch has no
uint16 ``minimum`` on the CPU).

The probe script's other parts (the ``cummax_1d`` kernel, P8, and the
counting sorts built on it) are not ported here; they come with the scan
probes in the next slice (ROADMAP). Where the JAX probe feeds zeros, this
one feeds seeded random rows, checked against the plain version, at the
probe's reps = 16 and at reps = 256, where the ALU, not the bytes, sets
the time.

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.explore_keys16``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..runtime.timing import device_time
from ..utils import interop
from . import ALU_OPS_PER_S, HBM_BYTES_PER_S

TOTAL_ROWS = 1 << 15
LANES = 128
REPS = 16
RATE_REPS = (REPS, 256)
DTYPES = (torch.int32, torch.uint16, torch.int16, torch.bfloat16)


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


def random_rows(dtype, rows: int, seed: int, device) -> torch.Tensor:
    """Seeded random rows of `dtype` (16-bit ones as random patterns), with
    the values the lane types disagree on in the first rows: NaNs of both
    signs and payloads, subnormals, -0.0 and +0.0."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        u = rng.integers(-2**31, 2**31, (rows, LANES), dtype=np.int64).astype(np.int32)
        return torch.from_numpy(u).to(device)
    u = rng.integers(0, 2**16, (rows, LANES), dtype=np.int64).astype(np.uint16)
    special = np.array([0x7FC0, 0xFFC0, 0x7F81, 0xFF81, 0x7FFF, 0x0000, 0x8000, 0x0001,
                        0x8001, 0x007F, 0x7F80, 0xFF80, 0x3F80, 0xBF80, 0x7FEF, 0xFFFF],
                       np.uint16)
    u[: min(rows, 64)] = rng.choice(special, (min(rows, 64), LANES))
    return torch.from_numpy(u.view(np.int16)).to(device).view(dtype)


def stage_rate(dtype, reps: int = REPS, *, device="cuda", seed: int = 0) -> dict:
    """Element-stages a second through `reps` stages of the dtype over
    32,768 rows (the kernel's calls queued, so that their launch hides)."""
    dev = interop.resolve_device(device)
    x = random_rows(dtype, TOTAL_ROWS, seed, dev)
    ms = device_time(stage_kernel, x, reps, queued=True) * 1e3
    n_el = TOTAL_ROWS * LANES
    name = str(dtype).removeprefix("torch.")
    bytes_ms = 2 * x.element_size() * n_el / HBM_BYTES_PER_S * 1e3
    ops_ms = reps * n_el / ALU_OPS_PER_S * 1e3
    row = {"probe": "P9", "dtype": name, "reps": reps, "ms": ms,
           "gelem_stages_per_s": n_el * reps / ms / 1e6,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "plain_ms": device_time(stage_plain, x, reps, warmup=1, iters=3) * 1e3}
    print(f"stage rate {name:8s}: {row['gelem_stages_per_s']:7.2f} Gelem-stages/s "
          f"({ms:.4f} ms / {reps} stages of {n_el >> 20}M)", flush=True)
    return row


def check(device="cuda", seed=0) -> int:
    """Hold the kernel against :func:`stage_plain`, every dtype at reps 0,
    1, 16, 256 and an odd count, byte for byte; raise on a difference.
    Returns the largest |difference| (0)."""
    dev = interop.resolve_device(device)
    for dtype in DTYPES:
        x = random_rows(dtype, TOTAL_ROWS, seed, dev)
        view = torch.int32 if dtype == torch.int32 else torch.int16
        for reps in (0, 1, 7, *RATE_REPS):
            if not torch.equal(stage_kernel(x, reps).view(view), stage_plain(x, reps).view(view)):
                raise AssertionError(f"P9 {dtype} differs from its plain version at reps {reps}")
    return 0


def main(device="cuda") -> list[dict]:
    """Time every dtype at each of RATE_REPS; a row each."""
    dev = interop.resolve_device(device)
    return [stage_rate(dt, reps, device=dev) for dt in DTYPES for reps in RATE_REPS]


if __name__ == "__main__":
    check()
    main()
