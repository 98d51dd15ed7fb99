"""Blocked bitonic sorting network over co-sorted u32 columns.

Counterpart of ``tpu_radix_sort/ops/bitonic.py``. The columns live as one
``(n_arr, n)`` int32 tensor (u32 bit patterns, see ``common``); element i
pairs with i ^ j at stage (k, j) and the pair is ascending iff
``(i & k) == 0``. The network runs as a schedule of kernel calls:

1. phase 1, one tile call: every tile of T elements runs rounds k = 2..T
   (after it, tiles are sorted in alternating directions);
2. each merge round k = 2T..n: one global call per stride j >= T, then one
   tile call for the strides T/2..1 (the merge tail).

The row-local network (:func:`row_schedule`, the batched sorts) sorts every
aligned run of `row_len` elements on its own: the same rounds up to
k = row_len/2, whose runs never cross a row, then one final round whose
k, :data:`ROW_UP`, lies above every index, so that every pair of it is
ascending.

Kernel K1 (``csrc/bitonic.cu``) executes both call kinds on the card, in
place; :func:`stages_plain` is its plain PyTorch version, which applies a
stage list to the whole tensor and is what a CPU tensor runs. A call on a
CUDA tensor launches the kernel or raises. The stage list is the same
network for every T, and the column contract below makes the sorted order
unique, so the output does not depend on T.

The tile kernel holds its elements in registers, 32 per thread, in a
window: five consecutive index bits in registers. :func:`tile_plan` chooses
the window of each stage on the host (fewest changes); the kernel changes
window through shared memory only where the plan does.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils import dispatch
from . import common

LANES = 128  # smallest padded length: the JAX package's contract
MAX_ARRAYS = 8  # csrc/bitonic.cu TRS_DISPATCH; the widest 64-bit segmented path
MAX_KEYS = 4  # (segment, hi, lo, tie)
MAX_STAGES_PER_CALL = 128  # kMaxStages in csrc/bitonic.cu
MAX_TILE = 1 << 15  # phase 1 of a 2^15 tile is 120 stages
MAX_LENGTH = common.MAX_LENGTH  # indices stay u32 in the kernels
CHUNK_MIN = 1024  # the tile kernel's smallest chunk: 32 lanes x 32 registers
# k of the row-local network's final round: (i & ROW_UP) == 0 for every
# index i < MAX_LENGTH, so each of its pairs goes up
ROW_UP = MAX_LENGTH


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


def chunk_bits(tile: int) -> int:
    """log2 of the elements one block of the tile kernel holds: the tile,
    or one warp's 32 x 32 registers if that is more (``kChunkMin``)."""
    return max(tile, CHUNK_MIN).bit_length() - 1


def windows(bits: int):
    """The tile kernel's layouts for a chunk of 2**bits elements: window s
    holds index bits s..s+4 in registers (csrc/bitonic.cu); s = 0, or
    5 <= s <= bits - 5, where a warp's lanes sit on bits 0-4."""
    return [0] + list(range(5, bits - 4))


def tile_plan(stages, tile: int):
    """Cut a tile call's stage list into runs [(window, [stages])] with the
    fewest window changes: each stage runs in a window that holds the bit
    of its stride. The kernel loads and stores in a window s >= 5, so a plan
    that starts or ends in window 0 pays one more change there."""
    wins = windows(chunk_bits(tile))
    inf = float("inf")
    cost = {w: 1 if w == 0 else 0 for w in wins}
    back = []
    for _, j in stages:
        b = j.bit_length() - 1
        best = min(cost, key=lambda w: cost[w])
        new, came = {}, {}
        for w in wins:
            stay, move = cost[w], cost[best] + 1
            came[w] = w if stay <= move else best
            new[w] = min(stay, move) if w <= b <= w + 4 else inf
        back.append(came)
        cost = new
    w = min(wins, key=lambda w: cost[w] + (w == 0))
    plan = []
    for came in reversed(back):
        plan.append(w)
        w = came[w]
    plan.reverse()
    runs = []
    for stage, w in zip(stages, plan):
        if runs and runs[-1][0] == w:
            runs[-1][1].append(stage)
        else:
            runs.append((w, [stage]))
    return runs


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
    if not 2 <= n <= MAX_LENGTH:
        raise ValueError(f"length must be in [2, 2^31], got {n}")


def _check_pow2_cols(x: torch.Tensor, n_keys: int) -> None:
    _check_cols(x, n_keys)
    if not _is_pow2(x.shape[1]):
        raise ValueError(f"length must be a power of two, got {x.shape[1]}")


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def tile_stages(x: torch.Tensor, stages, *, n_keys: int, tile: int) -> torch.Tensor:
    """K1, tile form: run `stages` (every stride < `tile`) on each tile of
    `tile` elements of the columns x, in place. Returns x.

    The length is a multiple of the kernel's chunk, max(tile, 1,024)
    elements, or a multiple of `tile` shorter than one chunk."""
    _check_cols(x, n_keys)
    n_arr, n = x.shape
    if not _is_pow2(tile) or not 2 <= tile <= n:
        raise ValueError(f"tile must be a power of two in [2, {n}], got {tile}")
    chunk = 1 << chunk_bits(tile)
    if n % (tile if n < chunk else chunk):
        raise ValueError(f"length {n} is not a multiple of the chunk {chunk} or of "
                         f"tile {tile} below it")
    if len(stages) > MAX_STAGES_PER_CALL:
        raise ValueError(f"at most {MAX_STAGES_PER_CALL} stages per call")
    for k, j in stages:
        if not (_is_pow2(j) and j < tile and _is_pow2(k) and 2 * j <= k < 1 << 32):
            raise ValueError(f"stage {(k, j)} does not fit tile {tile}")
    if _device_kind(x) == "cpu":
        return stages_plain(x, stages, n_keys)
    # an array shorter than the kernel's chunk runs padded to one chunk: the
    # stand-ins pair only with each other (every stride < tile <= n)
    y = x
    if n < chunk:
        y = torch.zeros((n_arr, chunk), dtype=x.dtype, device=x.device)
        y[:, :n] = x
    arr = ctypes.c_uint * max(1, len(stages))
    ks = arr(*[k for k, _ in stages])
    js = arr(*[j for _, j in stages])
    wins = arr(*[w for w, run in tile_plan(stages, tile) for _ in run])
    _build.BITONIC_TILE(
        y.data_ptr(), y.shape[1], n_arr, n_keys, tile, ks, js, wins, len(stages),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if y is not x:
        x.copy_(y[:, :n])
    return x


def global_stage(x: torch.Tensor, k: int, j: int, *, n_keys: int) -> torch.Tensor:
    """K1, global form: one stage (k, j) over the whole columns x, in place,
    straight in device memory; the length is a multiple of 2j. Returns x."""
    _check_cols(x, n_keys)
    n_arr, n = x.shape
    if not (_is_pow2(j) and n % (2 * j) == 0 and _is_pow2(k) and 2 * j <= k < 1 << 32):
        raise ValueError(f"stage {(k, j)} does not fit length {n}")
    if _device_kind(x) == "cpu":
        return stages_plain(x, [(k, j)], n_keys)
    _build.BITONIC_GLOBAL_STAGE(
        x.data_ptr(), n, n_arr, n_keys, k, j,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return x


def _merge_round(k, tile, j_hi=None):
    """Kernel calls of one bitonic merge round k: strides `j_hi` (default
    k/2) down to 1 — global calls while a pair spans tiles (j >= tile), then
    one tile call for the rest."""
    j = k // 2 if j_hi is None else j_hi
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


def merge_tree_schedule(n: int, run: int, tile: int):
    """Kernel calls that finish a sort of length n whose rounds k <= `run`
    are done (n/run runs sorted in alternating directions): rounds k =
    2*run..n. Rounds that fit a tile (2*run <= tile) take one tile call,
    as phase 1 does; the rest are merge rounds. `run` >= n: no call."""
    if run >= n:
        return []
    calls = []
    k = 2 * run
    if k <= tile:
        calls.append(("tile", _block_stages(k, tile)))
        k = 2 * tile
    while k <= n:
        calls += _merge_round(k, tile)
        k *= 2
    return calls


def row_schedule(row_len: int, tile: int):
    """Kernel calls of the row-local network: every aligned run of
    `row_len` (a power of two) elements sorted ascending on its own.

    Rounds k = 2..row_len/2 are the full sort's (their runs never cross a
    row), after which each row is bitonic; one final round with k =
    :data:`ROW_UP` merges it, every pair ascending. With rows no longer
    than the tile that is one tile call; longer rows run phase 1, the merge
    rounds up to row_len/2 and the final round from stride row_len/2.
    """
    if row_len <= tile:
        return [("tile", _block_stages(2, row_len // 2)
                 + [(ROW_UP, j) for j in _halving(row_len // 2)])]
    calls = [("tile", _block_stages(2, tile))]
    k = 2 * tile
    while k <= row_len // 2:
        calls += _merge_round(k, tile)
        k *= 2
    return calls + _merge_round(ROW_UP, tile, j_hi=row_len // 2)


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
    _check_pow2_cols(x, n_keys)
    t = resolve_tile(x.shape[1], x.shape[0], tile)
    return run_schedule(x, sort_schedule(x.shape[1], t), n_keys=n_keys, tile=t)


def merge_padded_cols(x: torch.Tensor, *, n_keys: int, tile=None) -> torch.Tensor:
    """:func:`merge_padded` on one (n_arr, n) int32 tensor, in place."""
    _check_pow2_cols(x, n_keys)
    t = resolve_tile(x.shape[1], x.shape[0], tile)
    return run_schedule(x, merge_schedule(x.shape[1], t), n_keys=n_keys, tile=t)


def merge_tree_padded_cols(x: torch.Tensor, *, run: int, n_keys: int,
                           tile=None) -> torch.Tensor:
    """:func:`merge_tree_padded` on one (n_arr, n) int32 tensor, in place."""
    _check_pow2_cols(x, n_keys)
    if not _is_pow2(run) or x.shape[1] % run:
        raise ValueError(f"run must be a power of two dividing {x.shape[1]}, got {run}")
    t = resolve_tile(x.shape[1], x.shape[0], tile)
    return run_schedule(x, merge_tree_schedule(x.shape[1], run, t), n_keys=n_keys, tile=t)


def rows_layout(rows: int, row_len: int, n_arr: int, tile=None):
    """(tile, padded rows) of the row-local network for `rows` rows of
    `row_len`: the tile as :func:`resolve_tile` gives it for the whole
    array, and the row count rounded up so that the length is a multiple
    of the kernel's chunk (rows shorter than a chunk share one; the extra
    rows are the caller's sentinel rows, cut off after the sort)."""
    t = resolve_tile(common.next_pow2(rows * row_len), n_arr, tile)
    per_chunk = max(1, (1 << chunk_bits(t)) // row_len)
    return t, common.round_up(rows, per_chunk)


def sort_rows_padded_cols(x: torch.Tensor, *, row_len: int, n_keys: int,
                          tile=None) -> torch.Tensor:
    """Sort every aligned `row_len` run of the (n_arr, n) int32 columns x
    on its own, ascending, in place (the batched sorts' network,
    :func:`row_schedule`; counterpart of the JAX package's
    ``sort_rows_padded``). Same column contract as :func:`sort_padded`,
    with sentinel pads in each row; the length is a multiple of `row_len`
    and of the tile's chunk (:func:`rows_layout`), no power of two needed."""
    _check_cols(x, n_keys)
    n_arr, n = x.shape
    if not _is_pow2(row_len) or n % row_len:
        raise ValueError(f"row_len must be a power of two dividing {n}, got {row_len}")
    t = resolve_tile(common.next_pow2(n), n_arr, tile)
    if n % (1 << chunk_bits(t)):
        raise ValueError(f"length {n} is not a multiple of the chunk of tile {t}")
    return run_schedule(x, row_schedule(row_len, t), n_keys=n_keys, tile=t)


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


def merge_tree_padded(arrs, *, run, stable, tile=None, n_keys=None):
    """Complete a bitonic sort whose rounds k <= `run` are done: the
    columns hold n/run runs of `run` elements, run i sorted ascending if i
    is even and descending if odd (:func:`merge_tree_schedule`). Same
    column contract as :func:`sort_padded`. This is the exchange sort's
    D-way merge (``parallel/radix_exchange.py``); with run == n/2 it is
    :func:`merge_padded` of [A ascending ++ B descending]."""
    n_keys = (2 if stable else 1) if n_keys is None else n_keys
    x, dtype = _padded_cols(arrs)
    merge_tree_padded_cols(x, run=run, n_keys=n_keys, tile=tile)
    return tuple(row.view(dtype) for row in x)
