"""The primitives of a radix-vs-bitonic answer, measured on the card.

Counterpart of ``benchmarks/explore_msd.py``, which times the primitives an
MSD-bucket + batched-block-sort hybrid would be built from. At 2^24:

1. ``torch.sort(dim=1)`` by row length (512, 2,048, 8,192, 65,536), one
   operand;
2. at [8,192 x 2,048]: two operands (key + payload), unstable and stable,
   and three, stable: a sort of the key and a ``gather`` of each payload
   by its indices;
3. the radix engine at ``bit_count=4``: 2 passes of K5 + K4 + K6;
4. the bitonic engine keys-only at 2^24;
5. the padded row: [8,192 x 2,560], the 2,048 keys of a row and 512
   sentinels.

Keys are the sign-biased int32 view of u32 keys (``common.bias_i32``:
signed order = unsigned order), the yardstick convention of PERF.md. The
library calls are the probe's subject, not ports of a Pallas kernel.

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.explore_msd``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import common, radix
from ..ops.sort import sort
from ..runtime.timing import device_time
from ..utils import interop

N = 1 << 24
ROW_LENGTHS = (512, 2048, 8192, 65536)
ROW = 2048
PAD = 512
SENTINEL_BIASED = 0x7FFFFFFF  # 0xFFFFFFFF in the biased view


def u32(n: int, rng) -> np.ndarray:
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def biased(keys: np.ndarray, device) -> torch.Tensor:
    """The sign-biased int32 view of u32 keys, on the device."""
    return common.bias_i32(interop.from_numpy(keys.view(np.int32), device))


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1)[0]


def sort_with_payloads(k: torch.Tensor, *payloads: torch.Tensor, stable: bool):
    """Rows sorted by the key, each payload gathered by the key's order."""
    s, idx = torch.sort(k, dim=1, stable=stable)
    return (s, *(torch.gather(p, 1, idx) for p in payloads))


def pad_rows(x: torch.Tensor, pad: int = PAD) -> torch.Tensor:
    return torch.cat([x, torch.full((x.shape[0], pad), SENTINEL_BIASED, dtype=x.dtype,
                                    device=x.device)], dim=1)


def radix_bits4(u: torch.Tensor) -> torch.Tensor:
    """The radix engine over the low 4 bits (2 passes) of int32 u32 patterns."""
    return radix.sort_u32(u, bit_count=4)[0]


def bitonic_keys(u: torch.Tensor) -> torch.Tensor:
    return sort(u, method="bitonic")


def cases(device, n: int = N, seed: int = 0, row_lengths=ROW_LENGTHS, row: int = ROW):
    """Every row: (tag, fn, args, elements)."""
    dev = interop.resolve_device(device)
    rng = np.random.default_rng(seed)
    out = []
    for L in row_lengths:
        x = biased(u32(n, rng), dev).view(n // L, L)
        out.append((f"torch.sort [{n // L}x{L}] 1-op", sort_rows, (x,), n))
    C = n // row
    k = biased(u32(n, rng), dev).view(C, row)
    v = torch.arange(n, dtype=torch.int32, device=dev).view(C, row)
    w = biased(u32(n, rng), dev).view(C, row)
    out += [
        (f"torch.sort [{C}x{row}] 2-op unstable + gather",
         lambda a, b: sort_with_payloads(a, b, stable=False), (k, v), n),
        (f"torch.sort [{C}x{row}] 2-op stable + gather",
         lambda a, b: sort_with_payloads(a, b, stable=True), (k, v), n),
        (f"torch.sort [{C}x{row}] 3-op stable + 2 gathers",
         lambda a, b, c: sort_with_payloads(a, b, c, stable=True), (k, v, w), n),
    ]
    u = interop.from_numpy(u32(n, rng).view(np.int32), dev)
    out += [("radix bit_count=4 (2 passes: K5 + K4 + K6)", radix_bits4, (u,), n),
            (f"bitonic {n} keys-only", bitonic_keys, (u.view(torch.uint32),), n),
            (f"torch.sort [{C}x{row + row // 4}] 1-op (1.25x sentinel pad)",
             lambda a: sort_rows(pad_rows(a, row // 4)), (k,), n)]
    return out


def _np(t):
    return interop.to_numpy(t)


def expected(tag: str, args):
    """The numpy result of a row, from its inputs."""
    a = [_np(x) for x in args]
    if tag.startswith("radix"):
        u = a[0].view(np.uint32)
        return u[np.argsort(u & 0xF, kind="stable")].view(np.int32)
    if tag.startswith("bitonic"):
        return np.sort(a[0])
    if "gather" in tag:
        order = np.argsort(a[0], axis=1, kind="stable")
        return tuple(np.take_along_axis(x, order, axis=1) for x in a)
    if "pad" in tag:
        pad = np.full((a[0].shape[0], a[0].shape[1] // 4), SENTINEL_BIASED, np.int32)
        return np.sort(np.concatenate([a[0], pad], axis=1), axis=1)
    return np.sort(a[0], axis=1)


def _same(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        _np(g).dtype == w.dtype and np.array_equal(_np(g), w) for g, w in zip(got, want))


def check(device="cuda", n=N, seed=0, row_lengths=ROW_LENGTHS, row=ROW) -> int:
    """Every row against numpy on the same inputs, byte for byte (the
    unstable row: its keys, and each key's payload as the input pairs
    them). Raises on a difference; returns 0."""
    for tag, fn, args, _ in cases(device, n, seed, row_lengths, row):
        got = fn(*args)
        want = expected(tag, args)
        if "unstable" in tag:
            k, v = (_np(x) for x in args)
            gk, gv = (_np(x) for x in got)
            flat = gv.astype(np.int64).ravel()
            ok = np.array_equal(gk, want[0]) and np.array_equal(k.ravel()[flat], gk.ravel()) \
                and np.array_equal(np.sort(gv, axis=1), np.sort(v, axis=1))
        else:
            ok = _same(got, want)
        if not ok:
            raise AssertionError(f"{tag} differs from numpy")
    return 0


def main(device="cuda", n=N, seed=0) -> list[dict]:
    """Time every row; print and return a row each."""
    rows = []
    for tag, fn, args, elems in cases(device, n, seed):
        ms = device_time(fn, *args) * 1e3
        print(f"{tag:58s} {ms:9.3f} ms   {elems / ms / 1e6:7.2f} Gelem/s", flush=True)
        rows.append({"probe": "explore_msd", "case": tag, "n": elems, "ms": ms})
        if tag.startswith("radix"):
            print(f"   -> per 2-bit pass: {ms / 2:.3f} ms", flush=True)
    return rows


if __name__ == "__main__":
    check()
    main()
