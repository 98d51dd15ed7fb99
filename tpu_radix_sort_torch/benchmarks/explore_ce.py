"""Probe P1 on the card: the cost of a compare-exchange stage, per column
count and per formulation.

Counterpart of ``benchmarks/explore_ce.py`` (``run_variant`` :200, kernel
body ``_kernel`` :56). Its variants run 16 compare-exchange stages over
2^24 u32 elements (1-3 co-moving columns, or one u64 column), stage q
pairing element e with e ^ (128 * MS[q]). They compute three functions,
with a the element whose index bit is clear, b its partner and lt the
strict order of the key (column 0, then column 1 when the variant is
stable; unsigned, but signed for column 0 of the ``*minmax`` folds):

- ``'roll'``, ``'flip'`` and ``'u64'``: a <- lt(b, a) ? a : b, b <- lt(a, b) ?
  a : b (the larger tuple first, whatever the probe's comment says);
- ``'xorswap'`` and ``'flipminmax'``: swap iff lt(b, a) (ascending);
- ``'minmax'``, ``'fold2minmax'``, ``'fold3minmax'``: a <- lt(b, a) ? b : a,
  b <- lt(a, b) ? b : a (ascending; on a key tie a's payload goes to both).

:func:`ce_plain` computes them in PyTorch; :func:`ce_stages` launches
``csrc/explore_ce.cu`` on a CUDA tensor in either formulation (``'smem'``:
every stage through shared memory; ``'regs'``: register windows of five
index bits, as the K1 tile kernel keeps them) and with 16 or 0 stages.
:func:`probe_columns` builds the probe's input (column i = x + i), as its
``run_variant`` does.

The kernel splits the elements into independent problems of 512 rows x 16
lanes of one half tile and runs persistent blocks, as many as can be
resident, each walking the problems dealt round the SMs (:func:`ce_resident`)
with two teams of 8 warps, each team with its own problem buffer: one
team's copies in and out run while the other team runs its stages. So
(t16 - t0) / 16 is the time of a stage that the copies do not hide, not the
time of a stage alone.

Not ported from the probe's ``main``: ``bench_slicing_chunked`` (:239) and
``bench_engine_fold2`` (:282). They time the whole engine under the
TPU-only switches ``USE_SLICING_CE``, ``USE_FOLD2_CE`` and ``USE_FOLD3_CE``,
which the port does not have (ROADMAP, "What does not carry over"), and
their kernel is K1, which is ported.

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.explore_ce``
(``CE_ALL=1`` adds the probe's 'flip' and 'u64' lines).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .. import _build
from ..ops import common
from ..runtime.timing import device_time
from ..utils import interop
from . import ALU_OPS_PER_S, HBM_BYTES_PER_S

N = 1 << 24
LANES = 128
ROWS = N // LANES
TILE_ROWS = 1024
T = TILE_ROWS * LANES
# 16 row strides m (pair partner e ^ 128 m), cycling 1..256 rows
MS = [1 << (i % 9) for i in range(16)]
STAGES = len(MS)
FORMULATIONS = ("smem", "regs")
# The kernel's problems (csrc/explore_ce.cu kRows, kProbLanes): 512 rows x
# 16 lanes of one half of a tile, independent since the stages pair rows
# only within it. CE_THREADS threads a block (two teams of 256),
# CE_BUFFERS problems in its shared memory at once (one a team).
PROBLEM_ROWS = TILE_ROWS // 2
PROBLEM_LANES = 16
PROBLEM = PROBLEM_ROWS * PROBLEM_LANES
CE_THREADS = 512
CE_BUFFERS = 2

DESC, SWAP, FOLD = "desc", "swap", "fold"
# Function id of csrc/explore_ce.cu -> (kind, columns, key words, signed
# first key word, one u64 column).
FUNCTIONS = (
    (DESC, 1, 1, False, False),
    (DESC, 2, 2, False, False),
    (DESC, 3, 2, False, False),
    (FOLD, 1, 1, True, False),
    (FOLD, 2, 2, True, False),
    (FOLD, 3, 2, True, False),
    (SWAP, 1, 1, False, False),
    (SWAP, 2, 2, False, False),
    (SWAP, 3, 2, False, False),
    (DESC, 1, 1, False, True),
)
# (variant, columns, stable) -> function id: the cases the probe runs, and
# 'flipminmax', the one-column form of 'xorswap'.
VARIANTS = {
    ("roll", 1, False): 0, ("flip", 1, False): 0,
    ("roll", 2, True): 1, ("flip", 2, True): 1,
    ("roll", 3, True): 2,
    ("minmax", 1, False): 3,
    ("fold2minmax", 2, True): 4,
    ("fold3minmax", 3, True): 5,
    ("xorswap", 1, False): 6, ("flipminmax", 1, False): 6,
    ("xorswap", 2, True): 7,
    ("xorswap", 3, True): 8,
    ("u64", 1, False): 9,
}
# explore_ce.main's lines: (name, columns, variant, stable)
BENCHES = (
    ("baseline roll (1 arr)", 1, "roll", False),
    ("baseline roll (2 arr stable)", 2, "roll", True),
    ("baseline roll (3 arr stable)", 3, "roll", True),
    ("minmax biased-signed keys-only (1 arr)", 1, "minmax", False),
    ("fold2: minmax key + tuple-cmp rank (2 arr)", 2, "fold2minmax", True),
    ("fold3: minmax key + idx + payload (3 arr)", 3, "fold3minmax", True),
    ("xorswap select-free (1 arr)", 1, "xorswap", False),
    ("xorswap select-free (2 arr stable)", 2, "xorswap", True),
    ("xorswap select-free (3 arr stable)", 3, "xorswap", True),
)
# ... and those it adds under CE_ALL
CE_ALL_BENCHES = (
    ("flip partner (1 arr)", 1, "flip", False),
    ("flip partner (2 arr stable)", 2, "flip", True),
    ("u64 packed roll (1 arr)", 1, "u64", False),
)


def function_id(variant: str, n_arr: int, stable: bool) -> int:
    try:
        return VARIANTS[(variant, n_arr, bool(stable))]
    except KeyError:
        raise ValueError(f"no probe case ({variant!r}, {n_arr} columns, stable={stable}); "
                         f"the cases are {sorted(VARIANTS)}") from None


def ops_per_pair(variant: str, n_arr: int, stable: bool) -> int:
    """32-bit integer operations one compare-exchange of the case needs.
    One u32 column: a minimum and a maximum (2). One u64 column: a two-word
    compare and a select of each word of each side (6). Two or three
    columns: a two-word compare of (column 0, column 1) in each direction
    that the function decides (kSwap one, else two; a tie of both key
    words must give both sides b or both a) and a select of each column of
    each side."""
    kind, n_arr, n_keys, _, wide = FUNCTIONS[function_id(variant, n_arr, stable)]
    if n_arr == 1:
        return 6 if wide else 2
    return (1 if kind == SWAP else 2) * n_keys + 2 * n_arr


def stage_ops(variant: str, n_arr: int, stable: bool, n: int = N,
              n_stages: int = STAGES) -> int:
    """The operations of `n_stages` stages over n elements (n / 2 pairs a
    stage)."""
    return n_stages * n // 2 * ops_per_pair(variant, n_arr, stable)


def bound_ms(variant: str, n_arr: int, stable: bool, n: int = N) -> tuple[float, str]:
    """The least time of 16 stages on the card: the columns read once and
    written once at HBM_BYTES_PER_S, or the stage operations at
    ALU_OPS_PER_S, whichever is longer; and which of the two it is."""
    t_bytes = 2 * n_arr * (8 if variant == "u64" else 4) * n / HBM_BYTES_PER_S * 1e3
    t_ops = stage_ops(variant, n_arr, stable, n) / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ce_resident(variant: str, n_arr: int, stable: bool, formulation: str = "regs",
                n: int = N) -> dict:
    """On the current CUDA device, as the kernel's launch computes them: the
    case's blocks that can be resident on an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the SMs, the shared
    memory a block, and the grid that n elements launch (as many blocks as
    can be resident, never more than the n / PROBLEM problems)."""
    fn = function_id(variant, n_arr, stable)
    lib = _build.library("explore_ce")
    per_sm, sms, smem, grid = (ctypes.c_int() for _ in range(4))
    err = lib.trs_explore_ce_resident(fn, FORMULATIONS.index(formulation), ctypes.c_longlong(n),
                                      ctypes.byref(per_sm), ctypes.byref(sms),
                                      ctypes.byref(smem), ctypes.byref(grid))
    if err:
        raise RuntimeError(f"the launch of P1 could not be planned: CUDA error {err} "
                           f"({lib.trs_error_string(err).decode()})")
    return {"blocks_per_sm": per_sm.value, "sms": sms.value, "smem_bytes": smem.value,
            "grid": grid.value}


def _check(cols: torch.Tensor, fn: int) -> None:
    _, n_arr, _, _, wide = FUNCTIONS[fn]
    want = torch.int64 if wide else torch.int32
    if not isinstance(cols, torch.Tensor) or cols.dtype != want:
        raise TypeError(f"this case takes {want} columns of "
                        f"{'u64' if wide else 'u32'} bit patterns")
    if cols.dim() != 2 or cols.shape[0] != n_arr or not cols.is_contiguous():
        raise ValueError(f"this case takes a contiguous ({n_arr}, n) tensor")
    if cols.shape[1] == 0 or cols.shape[1] % T:
        raise ValueError(f"the length must be a positive multiple of {T}")
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {cols.device}")
    if cols.device.type == "cuda" and cols.data_ptr() % 16:
        raise ValueError("the kernel copies 16 bytes at a time: the columns must start "
                         "16-byte aligned")


def ce_plain(cols: torch.Tensor, variant: str, stable: bool,
             n_stages: int = STAGES) -> torch.Tensor:
    """Plain version: the first `n_stages` stages of the variant on the
    (columns, n) tensor (int32 u32 patterns, or int64 u64 patterns for
    ``'u64'``); a new tensor."""
    fn = function_id(variant, cols.shape[0], stable)
    _check(cols, fn)
    kind, n_arr, n_keys, signed, wide = FUNCTIONS[fn]
    sign = common.SIGN_I64 if wide else common.SIGN_I32
    x = cols.clone()
    for m in MS[:n_stages]:
        v = x.view(n_arr, -1, 2, LANES * m)
        a, b = v[:, :, 0], v[:, :, 1]
        ka, kb = (a[0], b[0]) if signed else (a[0] ^ sign, b[0] ^ sign)
        b_lt_a, a_lt_b = kb < ka, ka < kb
        if n_keys == 2:
            eq = a[0] == b[0]
            ta, tb = a[1] ^ sign, b[1] ^ sign
            b_lt_a |= eq & (tb < ta)
            a_lt_b |= eq & (ta < tb)
        if kind == DESC:
            na, nb = torch.where(b_lt_a, a, b), torch.where(a_lt_b, a, b)
        elif kind == SWAP:
            na, nb = torch.where(b_lt_a, b, a), torch.where(b_lt_a, a, b)
        else:
            na, nb = torch.where(b_lt_a, b, a), torch.where(a_lt_b, b, a)
        x = torch.stack([na, nb], dim=2).reshape(x.shape)
    return x


def ce_stages(cols: torch.Tensor, variant: str, stable: bool, *,
              formulation: str = "regs", n_stages: int = STAGES) -> torch.Tensor:
    """P1's kernel: 16 (or 0) stages of the variant on the (columns, n)
    tensor, n a multiple of 131,072; a new tensor. A CPU tensor runs
    :func:`ce_plain`; a CUDA tensor launches ``csrc/explore_ce.cu`` in the
    given formulation."""
    return ce_stages_into(cols, torch.empty_like(cols), variant, stable,
                          formulation=formulation, n_stages=n_stages)


def ce_stages_into(cols: torch.Tensor, out: torch.Tensor, variant: str, stable: bool, *,
                   formulation: str = "regs", n_stages: int = STAGES) -> torch.Tensor:
    """:func:`ce_stages` into `out`, a tensor like `cols` or `cols` itself
    (in place); returns `out`."""
    fn = function_id(variant, cols.shape[0], stable)
    _check(cols, fn)
    _check(out, fn)
    if formulation not in FORMULATIONS:
        raise ValueError(f"formulation must be one of {FORMULATIONS}")
    if n_stages not in (0, STAGES):
        raise ValueError(f"n_stages must be 0 or {STAGES}")
    if out.shape != cols.shape or out.device != cols.device:
        raise ValueError("out must have the shape and device of the columns")
    if cols.device.type == "cpu":
        return out.copy_(ce_plain(cols, variant, stable, n_stages))
    _build.EXPLORE_CE(cols.data_ptr(), out.data_ptr(), cols.shape[1], fn,
                      FORMULATIONS.index(formulation), n_stages,
                      torch.cuda.current_stream(cols.device).cuda_stream)
    return out


def probe_columns(x: torch.Tensor, n_arr: int, variant: str) -> torch.Tensor:
    """The probe's input: column i = x + i (u32 arithmetic), or for
    ``'u64'`` that column widened to u64 (zero high word)."""
    cols = torch.stack([(x.reshape(-1).to(torch.int64) + i) & 0xFFFFFFFF
                        for i in range(n_arr)])
    return cols if variant == "u64" else cols.to(torch.int32)


def tie_columns(n: int, n_arr: int, variant: str, seed: int, device) -> torch.Tensor:
    """A tie-heavy input with independent columns: column 0 takes 4 values
    with and without the top bit, column 1 four, the payload any."""
    rng = np.random.default_rng(seed)
    if variant == "u64":
        hi = rng.choice(np.array([0, 7, 0x80000000, 0xFFFFFFFF], np.uint64), n)
        lo = rng.choice(np.array([0, 1, 0x80000001, 0xFFFFFFFF], np.uint64), n)
        return torch.from_numpy(((hi << np.uint64(32)) | lo).view(np.int64)[None]).to(device)
    u = rng.integers(0, 2**32, (n_arr, n), dtype=np.uint64).astype(np.uint32)
    u[0] = rng.choice(np.array([0, 5, 0x80000000, 0xFFFFFFFF], np.uint32), n)
    if n_arr > 1:
        u[1] = rng.choice(np.array([1, 2, 0x80000002, 0xFFFFFFFE], np.uint32), n)
    return torch.from_numpy(u.view(np.int32)).to(device)


def _bits(seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2**32, (ROWS, LANES), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(u.view(np.int32)).to(device)


def bench(name, n_arr, variant, stable=False, *, device="cuda", seed=0) -> list[dict]:
    """Time the case in both formulations at 16 and 0 stages on the probe's
    2^24 input, beside a ``copy_`` of the same columns, and its plain
    version; print a line each; return them."""
    dev = interop.resolve_device(device)
    cols = probe_columns(_bits(seed, dev), n_arr, variant)
    b_ms, b_by = bound_ms(variant, n_arr, stable)
    plain_ms = device_time(ce_plain, cols, variant, stable, warmup=1, iters=3) * 1e3
    y = torch.empty_like(cols)
    copy_ms = device_time(y.copy_, cols, queued=True) * 1e3
    rows = []
    for form in FORMULATIONS:
        t16 = device_time(lambda c: ce_stages(c, variant, stable, formulation=form), cols,
                          queued=True) * 1e3
        t0 = device_time(lambda c: ce_stages(c, variant, stable, formulation=form,
                                             n_stages=0), cols, queued=True) * 1e3
        per_stage_ms = (t16 - t0) / STAGES
        rows.append({
            "probe": "P1", "name": name, "variant": variant, "columns": n_arr,
            "stable": stable, "formulation": form, "ms": t16, "ms_zero_stages": t0,
            "copy_ms": copy_ms, "us_per_stage": per_stage_ms * 1e3,
            "gelem_stages_per_s": N / per_stage_ms / 1e6 if per_stage_ms > 0 else None,
            "ops": stage_ops(variant, n_arr, stable), "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": plain_ms,
        })
        print(f"{name + ' ' + form:52s} {t16:8.4f} ms  0 stages {t0:8.4f} ms  "
              f"copy_ {copy_ms:8.4f} ms  {per_stage_ms * 1e3:7.3f} us/st", flush=True)
    return rows


CHECK_SIZES = (T, 2 * T, N)  # fewer problems than SMs, two tiles, the probe's size


def check(n_arr, variant, stable=False, *, device="cuda", seed=0) -> int:
    """Hold the kernel (both formulations, 16 and 0 stages) against
    :func:`ce_plain` on the probe's input and on a tie-heavy one, at each
    of CHECK_SIZES, byte for byte: two launches in a row on one stream into
    new tensors (a second launch after the first, whatever the first left
    behind), then one in place; raise on a difference. Returns the largest
    |difference| (0)."""
    dev = interop.resolve_device(device)
    for n in CHECK_SIZES:
        for cols in (probe_columns(_bits(seed, dev)[:n // LANES], n_arr, variant),
                     tie_columns(n, n_arr, variant, seed + 1, dev)):
            for n_stages in (STAGES, 0):
                want = ce_plain(cols, variant, stable, n_stages)
                for form in FORMULATIONS:
                    got = [ce_stages(cols, variant, stable, formulation=form,
                                     n_stages=n_stages) for _ in range(2)]
                    x = cols.clone()
                    ce_stages_into(x, x, variant, stable, formulation=form, n_stages=n_stages)
                    for what, t in (("first", got[0]), ("second", got[1]), ("in place", x)):
                        if not torch.equal(t, want):
                            raise AssertionError(
                                f"P1 {variant} ({n_arr} columns, stable={stable}, {form}, "
                                f"{n_stages} stages, n = {n}, {what} launch) differs from "
                                f"its plain version")
    return 0


def cases(ce_all: bool | None = None):
    """The probe's lines; with CE_ALL (or `ce_all`) its 'flip' and 'u64' ones too."""
    if ce_all is None:
        ce_all = bool(os.environ.get("CE_ALL"))
    return BENCHES + (CE_ALL_BENCHES if ce_all else ())


def main(device="cuda", ce_all: bool | None = None) -> list[dict]:
    """Time every case of :func:`cases`; a row each per formulation."""
    dev = interop.resolve_device(device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}",
          flush=True)
    print(f"16 row-stride stages at {N >> 20}M u32, tile {TILE_ROWS}x{LANES}", flush=True)
    rows = []
    for name, n_arr, variant, stable in cases(ce_all):
        rows += bench(name, n_arr, variant, stable, device=dev)
    return rows


if __name__ == "__main__":
    for _, n_arr, variant, stable in cases():
        check(n_arr, variant, stable)
    main()
