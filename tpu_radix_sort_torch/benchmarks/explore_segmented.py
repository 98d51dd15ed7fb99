"""Price a row-local path for near-equal segments.

Counterpart of ``benchmarks/explore_segmented.py``. ``sort_segments`` runs
the composite (segment, key) network over the whole array, O(log^2 n)
stages, where equal-length segments could take ``sort_batched``'s row-local
network, O(log^2 row). A row-local path must first gather the ragged
segments into padded rows (padded[i, j] = flat[offsets[i] + j]) and
scatter them back. At 2^24 keys in 1,024 near-equal segments this measures:

1. the composite ``sort_segments`` (what ships);
2. ``sort_batched`` of the same keys already laid out as 1,024 rows (the
   bound of any row-local path);
3. gather-pad, ``sort_batched``, scatter-back (the candidate path, rows
   padded to the next power of two above the longest segment);
4. the gather and the scatter alone.

CUDA has no index of uint32, so the gather and scatter move the int32
view with int64 indices; masked lanes scatter to a dump slot at n. Rows
(1) and (3) are checked byte for byte against the per-segment golden
(``np.lexsort``), row (4) against the input. This measures the path; it
does not make ``sort_segments`` take it.

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.explore_segmented``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.batched import sort_batched
from ..ops.segmented import sort_segments
from ..runtime.timing import device_time
from ..utils import interop

N = 1 << 24
SEGMENTS = 1024
SENTINEL = -1  # 0xFFFFFFFF as int32: sorts after every key


def make_data(n: int = N, segments: int = SEGMENTS, seed: int = 0):
    """Keys, offsets (int64, S + 1) and segment sizes, as the JAX script
    makes them: sizes L +- 12% (L = n / S) with a zero-sum jitter."""
    rng = np.random.default_rng(seed)
    L = n // segments
    delta = rng.integers(-L // 8, L // 8, segments).astype(np.int64)
    delta -= delta.sum() // segments
    rem = int(delta.sum())
    delta[: abs(rem)] -= np.sign(rem)
    sizes = np.full(segments, L, np.int64) + delta
    assert sizes.min() > 0 and sizes.sum() == n
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return keys, offsets, sizes


def golden(keys: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    seg_ids = np.repeat(np.arange(sizes.size), sizes)
    return keys[np.lexsort((keys, seg_ids))]


def row_pad(sizes: np.ndarray) -> int:
    """The padded row: the next power of two above the longest segment."""
    return 1 << int(np.ceil(np.log2(sizes.max())))


def _layout(offsets: torch.Tensor, P: int, n: int):
    """Source positions (S, P) int64, clipped into [0, n), and the mask of
    real elements."""
    lens = offsets[1:] - offsets[:-1]
    j = torch.arange(P, device=offsets.device)
    src = offsets[:-1, None] + j[None, :]
    return src.clamp(max=n - 1), j[None, :] < lens[:, None], src


def gather_pad(a: torch.Tensor, offsets: torch.Tensor, P: int) -> torch.Tensor:
    """padded[i, j] = a[offsets[i] + j] for j < len_i, else the sentinel
    (int32 view of u32 keys)."""
    src, valid, _ = _layout(offsets, P, a.shape[0])
    return torch.where(valid, a.view(torch.int32)[src], SENTINEL)


def scatter_back(rows: torch.Tensor, offsets: torch.Tensor, n: int) -> torch.Tensor:
    """out[offsets[i] + r] = rows[i, r] for r < len_i; the rest of each row
    goes to a dump slot at n, cut off."""
    _, valid, src = _layout(offsets, rows.shape[1], n)
    pos = torch.where(valid, src, n).reshape(-1)
    out = torch.empty(n + 1, dtype=torch.int32, device=rows.device)
    out[pos] = rows.view(torch.int32).reshape(-1)
    return out[:n].view(torch.uint32)


def rowlocal_roundtrip(a: torch.Tensor, offsets: torch.Tensor, P: int) -> torch.Tensor:
    """Row (3): gather-pad, the row-local sort, scatter-back."""
    padded = gather_pad(a, offsets, P)
    return scatter_back(sort_batched(padded.view(torch.uint32)), offsets, a.shape[0])


def movement_only(a: torch.Tensor, offsets: torch.Tensor, P: int) -> torch.Tensor:
    """Row (4): the gather and the scatter alone."""
    return scatter_back(gather_pad(a, offsets, P), offsets, a.shape[0])


def rows(device, n: int = N, segments: int = SEGMENTS, seed: int = 0):
    """The four rows as (name, fn, args, expected numpy result or None)."""
    dev = interop.resolve_device(device)
    keys, offsets, sizes = make_data(n, segments, seed)
    ref = golden(keys, sizes)
    k = interop.from_numpy(keys, dev)
    offs = interop.from_numpy(offsets, dev)
    P = row_pad(sizes)
    L = n // segments
    keq = interop.from_numpy(keys[: segments * L].reshape(segments, L), dev)
    return [
        (f"{n}/{segments} near-equal segmented (composite, ships)",
         lambda a: sort_segments(a, offs), (k,), ref),
        (f"{segments}x{L} already rows (row-local bound)", sort_batched, (keq,), None),
        (f"{n}/{segments} gather-pad + row-local ({segments}x{P}) + scatter-back",
         lambda a: rowlocal_roundtrip(a, offs, P), (k,), ref),
        (f"{n}/{segments} gather-pad + scatter-back alone",
         lambda a: movement_only(a, offs, P), (k,), keys),
    ]


def check(device="cuda", n=N, segments=SEGMENTS, seed=0) -> int:
    """Rows (1), (3) against the golden, (4) against the input, (2)
    against ``np.sort`` of each row, byte for byte. Raises on a
    difference; returns 0."""
    for name, fn, args, want in rows(device, n, segments, seed):
        got = interop.to_numpy(fn(*args))
        if want is None:
            want = np.sort(interop.to_numpy(args[0]), axis=1)
        if got.dtype != want.dtype or not np.array_equal(got, want):
            raise AssertionError(f"{name} differs from its expected result")
    return 0


def main(device="cuda", n=N, segments=SEGMENTS, seed=0) -> list[dict]:
    """Time the four rows; print and return a row each."""
    out = []
    for name, fn, args, _ in rows(device, n, segments, seed):
        ms = device_time(fn, *args) * 1e3
        elems = args[0].numel()
        print(f"{name:60s} {ms:9.3f} ms  {elems / ms / 1e6:7.3f} Gkeys/s", flush=True)
        out.append({"probe": "explore_segmented", "row": name, "n": elems, "ms": ms})
    return out


if __name__ == "__main__":
    check()
    main()
