"""Blocked bitonic sorting network over co-sorted u32 columns.

Counterpart of ``tpu_radix_sort/ops/bitonic.py``. The columns live as one
``(n_arr, n)`` int32 tensor (u32 bit patterns, see ``common``); element i
pairs with i ^ j at stage (k, j) and the pair is ascending iff
``(i & k) == 0``. The network runs as a schedule of kernel calls:

1. phase 1, one tile call: every tile of T elements runs rounds k = 2..T
   (after it, tiles are sorted in alternating directions);
2. each merge round k = 2T..n: one global call per stride j >= T, then one
   tile call for the strides T/2..1 (the merge tail).

Kernel K1 (``csrc/bitonic.cu``) executes both call kinds on the card, in
place; :func:`stages_plain` is its plain PyTorch version, which applies a
stage list to the whole tensor and is what a CPU tensor runs. A call on a
CUDA tensor launches the kernel or raises. The stage list is the same
network for every T, and the column contract below makes the sorted order
unique, so the output does not depend on T.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import dispatch
from . import common

LANES = 128  # smallest padded length: the JAX package's contract
MAX_ARRAYS = 5
MAX_KEYS = 3
MAX_STAGES_PER_CALL = 128  # kMaxStages in csrc/bitonic.cu
MAX_TILE = 1 << 15  # phase 1 of a 2^15 tile is 120 stages
MAX_LENGTH = 1 << 31  # indices stay u32 in the kernels


def _block_stages(k_lo, k_hi):
    """Stage list [(k, j)] for rounds k = k_lo..k_hi, strides k/2..1."""
    stages = []
    k = k_lo
    while k <= k_hi:
        stages += [(k, j) for j in _halving(k // 2)]
        k *= 2
    return stages


def _halving(j):
    out = []
    while j >= 1:
        out.append(j)
        j //= 2
    return out


def _is_pow2(v: int) -> bool:
    return v >= 1 and (v & (v - 1)) == 0


def _lex_lt(a, b):
    """Unsigned lexicographic a < b over the leading dimension (key columns)."""
    lt = common.bias_i32(a[-1]) < common.bias_i32(b[-1])
    for c in range(a.shape[0] - 2, -1, -1):
        lt = (common.bias_i32(a[c]) < common.bias_i32(b[c])) | ((a[c] == b[c]) & lt)
    return lt


def stages_plain(x: torch.Tensor, stages, n_keys: int) -> torch.Tensor:
    """Plain version of K1: apply `stages` [(k, j)] to the columns x in place.

    A pair is swapped iff it is strictly out of order in its direction
    (lexicographic, unsigned, over the leading `n_keys` columns).
    """
    n_arr, n = x.shape
    for k, j in stages:
        v = x.view(n_arr, n // (2 * j), 2, j)
        lo, hi = v[:, :, 0], v[:, :, 1]
        first = torch.arange(0, n, 2 * j, device=x.device, dtype=torch.int64)
        up = ((first & k) == 0)[:, None]
        swap = torch.where(up, _lex_lt(hi[:n_keys], lo[:n_keys]),
                           _lex_lt(lo[:n_keys], hi[:n_keys]))
        new_lo = torch.where(swap, hi, lo)
        new_hi = torch.where(swap, lo, hi)
        v[:, :, 0] = new_lo
        v[:, :, 1] = new_hi
    return x


def _check_cols(x: torch.Tensor, n_keys: int) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.int32:
        raise TypeError("columns must be an int32 tensor of u32 bit patterns")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("columns must be one contiguous (n_arr, n) tensor")
    n_arr, n = x.shape
    if not 1 <= n_arr <= MAX_ARRAYS:
        raise ValueError(f"1..{MAX_ARRAYS} columns supported, got {n_arr}")
    if not 1 <= n_keys <= min(MAX_KEYS, n_arr):
        raise ValueError(f"n_keys must be in 1..{min(MAX_KEYS, n_arr)}, got {n_keys}")
    if not _is_pow2(n) or n < 2 or n > MAX_LENGTH:
        raise ValueError(f"length must be a power of two in [2, 2^31], got {n}")


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def tile_stages(x: torch.Tensor, stages, *, n_keys: int, tile: int) -> torch.Tensor:
    """K1, tile form: run `stages` (every stride < `tile`) on each tile of
    `tile` elements of the columns x, in place. Returns x."""
    _check_cols(x, n_keys)
    n_arr, n = x.shape
    if not _is_pow2(tile) or not 2 <= tile <= n:
        raise ValueError(f"tile must be a power of two in [2, {n}], got {tile}")
    if len(stages) > MAX_STAGES_PER_CALL:
        raise ValueError(f"at most {MAX_STAGES_PER_CALL} stages per call")
    for k, j in stages:
        if not (_is_pow2(j) and j < tile and _is_pow2(k) and 2 * j <= k < 1 << 32):
            raise ValueError(f"stage {(k, j)} does not fit tile {tile}")
    if _device_kind(x) == "cpu":
        return stages_plain(x, stages, n_keys)
    ks = (ctypes.c_uint * max(1, len(stages)))(*[k for k, _ in stages])
    js = (ctypes.c_uint * max(1, len(stages)))(*[j for _, j in stages])
    _build.BITONIC_TILE(
        x.data_ptr(), n, n_arr, n_keys, tile, ks, js, len(stages),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return x


def global_stage(x: torch.Tensor, k: int, j: int, *, n_keys: int) -> torch.Tensor:
    """K1, global form: one stage (k, j) over the whole columns x, in place,
    straight in device memory. Returns x."""
    _check_cols(x, n_keys)
    n_arr, n = x.shape
    if not (_is_pow2(j) and 2 * j <= n and _is_pow2(k) and 2 * j <= k < 1 << 32):
        raise ValueError(f"stage {(k, j)} does not fit length {n}")
    if _device_kind(x) == "cpu":
        return stages_plain(x, [(k, j)], n_keys)
    _build.BITONIC_GLOBAL_STAGE(
        x.data_ptr(), n, n_arr, n_keys, k, j,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return x


def _merge_round(k, tile):
    """Kernel calls of one bitonic merge round k: strides k/2 down to 1 —
    global calls while a pair spans tiles (j >= tile), then one tile call
    for the rest."""
    j = k // 2
    calls = []
    while j >= tile:
        calls.append(("global", k, j))
        j //= 2
    if j >= 1:
        calls.append(("tile", [(k, jj) for jj in _halving(j)]))
    return calls


def sort_schedule(n: int, tile: int):
    """Kernel calls of a full bitonic sort of length n with tile `tile`."""
    calls = [("tile", _block_stages(2, tile))]
    k = 2 * tile
    while k <= n:
        calls += _merge_round(k, tile)
        k *= 2
    return calls


def merge_schedule(n: int, tile: int):
    """Kernel calls of one bitonic merge of length n: round k = n, where
    every index i < n has (i & n) == 0, so the direction is ascending."""
    return _merge_round(n, tile)


def run_schedule(x: torch.Tensor, calls, *, n_keys: int, tile: int) -> torch.Tensor:
    for call in calls:
        if call[0] == "tile":
            tile_stages(x, call[1], n_keys=n_keys, tile=tile)
        else:
            global_stage(x, call[1], call[2], n_keys=n_keys)
    return x


def resolve_tile(n: int, n_arr: int, tile=None) -> int:
    """The tile for a padded length n: `tile` if given (validated against
    the shared-memory budget), else the largest that fits."""
    if tile is None:
        tile = min(MAX_TILE, dispatch.choose_tile(n, n_arr))
    if not _is_pow2(tile) or not 2 <= tile <= MAX_TILE:
        raise ValueError(f"tile must be a power of two in [2, {MAX_TILE}], got {tile}")
    if n_arr * tile * 4 > dispatch.SMEM_BUDGET_BYTES:
        raise ValueError(
            f"{n_arr} columns of tile {tile} exceed "
            f"{dispatch.SMEM_BUDGET_BYTES} bytes of shared memory"
        )
    return min(tile, n)


def _padded_cols(arrs):
    arrs = list(arrs)
    dtype = arrs[0].dtype
    n = arrs[0].shape[0]
    if any(a.dim() != 1 or a.shape[0] != n or a.dtype.itemsize != 4 for a in arrs):
        raise ValueError("columns must be 1-D 32-bit tensors of one length")
    if not _is_pow2(n) or n < LANES:
        raise ValueError(f"padded length must be pow2 >= {LANES}, got {n}")
    return torch.stack([a.view(torch.int32) for a in arrs]), dtype


def sort_padded_cols(x: torch.Tensor, *, n_keys: int, tile=None) -> torch.Tensor:
    """:func:`sort_padded` on one (n_arr, n) int32 tensor, in place."""
    _check_cols(x, n_keys)
    t = resolve_tile(x.shape[1], x.shape[0], tile)
    return run_schedule(x, sort_schedule(x.shape[1], t), n_keys=n_keys, tile=t)


def merge_padded_cols(x: torch.Tensor, *, n_keys: int, tile=None) -> torch.Tensor:
    """:func:`merge_padded` on one (n_arr, n) int32 tensor, in place."""
    _check_cols(x, n_keys)
    t = resolve_tile(x.shape[1], x.shape[0], tile)
    return run_schedule(x, merge_schedule(x.shape[1], t), n_keys=n_keys, tile=t)


def sort_padded(arrs, *, stable, tile=None, n_keys=None):
    """Sort a tuple of u32 columns lexicographically by the leading `n_keys`
    columns, ascending (default n_keys: 2 when `stable` — (key, tie) — else 1).

    Columns are 1-D uint32 or int32 tensors of one power-of-two length
    >= 128 (pad with 0xFFFFFFFF sentinels upstream; they sort to the tail).
    When `stable`, the last key column is the tie-break: real elements' key
    tuples must be pairwise distinct. Elements sharing a full key tuple are
    allowed only if they are identical across all columns (sentinel pads, or
    keys-only sorts where the tuple is the data). Returns the columns
    co-permuted, in the dtype of the first column.
    """
    n_keys = (2 if stable else 1) if n_keys is None else n_keys
    x, dtype = _padded_cols(arrs)
    sort_padded_cols(x, n_keys=n_keys, tile=tile)
    return tuple(row.view(dtype) for row in x)


def merge_padded(arrs, *, stable, tile=None, n_keys=None):
    """Sort a *bitonic* tuple of u32 columns ascending (one bitonic merge).

    Same contract as :func:`sort_padded`, but the key tuple must already
    form a bitonic sequence (e.g. ascending ++ descending halves): runs only
    the log2(n) stages of the final merge.
    """
    n_keys = (2 if stable else 1) if n_keys is None else n_keys
    x, dtype = _padded_cols(arrs)
    merge_padded_cols(x, n_keys=n_keys, tile=tile)
    return tuple(row.view(dtype) for row in x)
