"""4-way LSD radix sort: digit histogram, bucket offsets, stable reorder.

Counterpart of ``tpu_radix_sort/ops/radix.py``, the engine behind
``method='radix'``: ``bit_count // 2`` passes of

1. the digit histogram, kernel K5 (``csrc/radix.cu``
   ``digit_histogram_kernel``): per tile of `tile` keys, the count of each
   2-bit digit ``(key >> bit) & 3``, as the digit-major ``[4, nblocks]``
   table of the reference (`src/shaders/RadixSort.ts:110-114`);
2. the bucket offsets, kernel K4 (``ops/scan.py``) over the flattened
   table: its exclusive scan gives, for each (digit, tile), the start of
   that tile's digit run in the output;
3. the stable reorder, kernel K6 (``csrc/radix.cu`` ``reorder_kernel``):
   each element goes to ``offs[digit, tile] + its rank among the earlier
   elements of its tile with that digit``; every column moves with the key.

The columns live as one ``(n_arr, n)`` int32 tensor (u32 bit patterns, see
``common``), and two such buffers serve in turn across passes. K5 and K6
must share one tile; a pass's output does not depend on it, because a
stable partition by digit is unique. ``check_order=True`` runs the
reference's mid-sort order check (K2, ``checksort``) before every 2nd pass
and stops once the keys are sorted; the check is a host branch.

Each kernel has its plain PyTorch version beside it
(:func:`digit_histogram_plain`, :func:`reorder_pass_plain`), which a CPU
tensor runs; on a CUDA tensor the wrappers launch the kernel or raise.
"""
from __future__ import annotations

import torch

from .. import _build
from . import checksort, common, scan

RADIX_BITS = 2
R = 1 << RADIX_BITS  # 4-way, as the reference (src/shaders/RadixSort.ts:61)
# The reference checks the order before every 2nd pass
# (`AbstractRadixSortKernel.ts:257`, `i % 2 == 0`).
CHECK_EVERY_PASSES = 2
DEFAULT_TILE = 4096  # keys per CUDA block of K5 and K6
MIN_TILE, MAX_TILE = 32, 1 << 16  # csrc/radix.cu check_tile
# the 64-bit key path's widest: lo, carrying hi, the full key's (hi, lo)
# (bit_count < 64) and an 8-byte value's (hi, lo)
MAX_ARRAYS = 6
MAX_LENGTH = 1 << 31  # offsets and positions stay u32 in the kernels


def _digits(u: torch.Tensor, bit: int) -> torch.Tensor:
    # int32 >> is arithmetic, but & 3 keeps only bits bit and bit + 1 <= 31
    return (u >> bit) & (R - 1)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_tile(tile: int) -> None:
    if not (MIN_TILE <= tile <= MAX_TILE and tile & (tile - 1) == 0):
        raise ValueError(
            f"radix tile must be a power of two in [{MIN_TILE}, {MAX_TILE}], got {tile}")


def _check_bit(bit: int) -> None:
    if not 0 <= bit <= 32 - RADIX_BITS:
        raise ValueError(f"bit must be in [0, {32 - RADIX_BITS}], got {bit}")


def _check_device(x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def digit_histogram_plain(u: torch.Tensor, *, bit: int, tile: int) -> torch.Tensor:
    """Plain version of K5: the digit-major [4, nblocks] int32 table of the
    2-bit digits at `bit` of each tile of `tile` keys (the ragged last tile
    counts only its real keys)."""
    n = u.shape[0]
    nblocks = common.cdiv(n, tile)
    blk = torch.arange(n, device=u.device) // tile
    idx = _digits(u, bit).to(torch.int64) * nblocks + blk
    return torch.bincount(idx, minlength=R * nblocks).to(torch.int32).view(R, nblocks)


def digit_histogram(u: torch.Tensor, *, bit: int, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """K5: the digit-major [4, nblocks] histogram of a 1-D int32 (u32
    pattern) key tensor, nblocks = ceil(n / tile), on the keys' device."""
    if not isinstance(u, torch.Tensor) or u.dtype != torch.int32:
        raise TypeError("digit_histogram takes an int32 tensor of u32 bit patterns")
    if u.dim() != 1 or not u.is_contiguous():
        raise ValueError("digit_histogram takes one contiguous 1-D tensor")
    if u.shape[0] >= MAX_LENGTH:
        raise ValueError("length must stay below 2^31")
    _check_bit(bit)
    _check_tile(tile)
    _check_device(u)
    if u.device.type == "cpu":
        return digit_histogram_plain(u, bit=bit, tile=tile)
    n = u.shape[0]
    hist = torch.empty((R, common.cdiv(n, tile)), dtype=torch.int32, device=u.device)
    if n:
        _build.DIGIT_HISTOGRAM(u.data_ptr(), n, bit, tile, hist.data_ptr(), _stream(u))
    return hist


def bucket_offsets(hist: torch.Tensor) -> torch.Tensor:
    """Exclusive scan (K4) of the digit-major histogram: offsets[r, b] is
    where tile b's run of digit r starts in the output (the reference's
    `prefix_block_sum`, `RadixSortReorder.ts:97-99`)."""
    return scan.scan_kernel(hist.reshape(-1), inclusive=False).view(hist.shape)


def reorder_pass_plain(x: torch.Tensor, offs: torch.Tensor, *, bit: int, tile: int,
                       out: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: write the columns x, stably split by the digit
    of x[0] at `bit`, into `out` — the element of tile b with digit r and
    rank k among its tile's digit-r elements goes to offs[r, b] + k."""
    n = x.shape[1]
    nblocks = common.cdiv(n, tile)
    d = _digits(x[0], bit).to(torch.int64)
    hit = torch.zeros((R, nblocks * tile), dtype=torch.int64, device=x.device)
    hit[:, :n] = d[None, :] == torch.arange(R, device=x.device)[:, None]
    upto = hit.view(R, nblocks, tile).cumsum(2).view(R, -1)[:, :n]
    rank = upto.gather(0, d[None, :])[0] - 1
    blk = torch.arange(n, device=x.device) // tile
    start = (offs.to(torch.int64) & 0xFFFFFFFF)[d, blk]
    out[:, start + rank] = x
    return out


def reorder_pass(x: torch.Tensor, offs: torch.Tensor, *, bit: int,
                 tile: int = DEFAULT_TILE, out: torch.Tensor | None = None) -> torch.Tensor:
    """K6: one stable 4-way split of the (n_arr, n) int32 columns x by the
    digit of x[0] at `bit`, written into `out` (a new tensor if None).

    `offs` is :func:`bucket_offsets` of :func:`digit_histogram` of x[0] at
    the same `bit` and `tile`. Returns `out`.
    """
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError("columns must be an int32 tensor of u32 bit patterns")
    if x.dim() != 2 or not x.is_contiguous() or not 1 <= x.shape[0] <= MAX_ARRAYS:
        raise ValueError(f"columns must be one contiguous (n_arr, n) tensor, n_arr 1..{MAX_ARRAYS}")
    n_arr, n = x.shape
    if n >= MAX_LENGTH:
        raise ValueError("length must stay below 2^31")
    _check_bit(bit)
    _check_tile(tile)
    _check_device(x)
    nblocks = common.cdiv(n, tile)
    if (offs.dtype != torch.int32 or offs.shape != (R, nblocks)
            or not offs.is_contiguous() or offs.device != x.device):
        raise ValueError(f"offs must be a contiguous int32 ({R}, {nblocks}) tensor beside x")
    if out is None:
        out = torch.empty_like(x)
    elif (out.dtype != x.dtype or out.shape != x.shape or not out.is_contiguous()
          or out.device != x.device or out.data_ptr() == x.data_ptr()):
        raise ValueError("out must be a contiguous tensor like x, apart from it")
    if x.device.type == "cpu":
        return reorder_pass_plain(x, offs, bit=bit, tile=tile, out=out)
    if n:
        _build.REORDER(x.data_ptr(), out.data_ptr(), n, n_arr, bit, tile, offs.data_ptr(),
                       _stream(x))
    return out


def sort_u32(mkeys, payloads=(), *, bit_count=32, tile=None, check_order=False,
             return_passes=False):
    """Stable ascending LSD radix sort of 1-D int32 (u32 pattern) keys by
    their low `bit_count` bits, co-permuting int32 payload columns.

    ``bit_count // 2`` passes of histogram -> offsets -> reorder, the
    reference's pass structure (`AbstractRadixSortKernel.ts:94-107`).
    ``check_order=True`` is the reference's mid-sort early exit
    (`AbstractRadixSortKernel.ts:249-276`): before every 2nd pass the
    order check runs on the working keys and, once they are sorted, the
    remaining passes are skipped. Returns (keys, payloads), plus the
    number of passes that ran when `return_passes`.
    """
    cols = [mkeys, *payloads]
    n = mkeys.shape[0]
    if any(c.dtype != torch.int32 or c.dim() != 1 or c.shape[0] != n for c in cols):
        raise ValueError("keys and payloads must be 1-D int32 tensors of one length")
    if len(cols) > MAX_ARRAYS:
        raise ValueError(f"at most {MAX_ARRAYS - 1} payload columns")
    if n >= MAX_LENGTH:
        raise ValueError(f"radix engine supports < 2^31 elements, got {n}")
    if bit_count % RADIX_BITS or not 0 <= bit_count <= 32:
        raise ValueError(f"bit_count must be even in [0, 32], got {bit_count}")
    tile = DEFAULT_TILE if tile is None else tile
    _check_tile(tile)
    x = torch.stack(cols)
    y = torch.empty_like(x)
    n_run = 0
    for i in range(bit_count // RADIX_BITS):
        if check_order and i % CHECK_EVERY_PASSES == 0 and checksort.is_sorted_cols((x[0],)):
            break
        bit = i * RADIX_BITS
        offs = bucket_offsets(digit_histogram(x[0], bit=bit, tile=tile))
        reorder_pass(x, offs, bit=bit, tile=tile, out=y)
        x, y = y, x
        n_run += 1
    keys, rest = x[0], tuple(x[1:])
    return (keys, rest, n_run) if return_passes else (keys, rest)
