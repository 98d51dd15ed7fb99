"""Data-movement primitives of a radix engine, measured on the card.

Counterpart of ``benchmarks/explore_primitives.py``, which probes the TPU's
candidate primitives for the radix engine's scatter. At 2^22 and 2^26:

- elementwise +1, the roofline (8n bytes);
- ``torch.sort`` stable keys-only, and key + value (a sort and a
  ``gather`` of the value by its indices);
- a random gather ``x[perm]`` and scatter ``out[perm] = x`` (12n bytes);

then, at 2^22, the bfloat16 one-hot matmul permute of blocks of B = 256,
512 and 1,024 (integers below 256, exact in bfloat16), and at 2^24 the
gather with coalesced indices (``x[iota]``) and with indices random
inside windows of 1,024.

Keys are the sign-biased int32 view of u32 keys; indices are int64 (CUDA
has no index of uint32). The library calls are the probe's subject, not
ports of a Pallas kernel. The JAX script runs at import; here the work is
in ``main`` (and ``check``).

Run on the card: ``python -m tpu_radix_sort_torch.benchmarks.explore_primitives``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import common
from ..runtime.timing import device_time
from ..utils import interop
from . import HBM_BYTES_PER_S

SIZES = (1 << 22, 1 << 26)
ONEHOT_N = 1 << 22
BLOCKS = (256, 512, 1024)
GATHER_N = 1 << 24
WINDOW = 1024
CHECK_SIZES = (1 << 22,)
CHECK_ONEHOT_N = 1 << 16


def add_one(x):
    return x + 1


def sort_keys(x):
    return torch.sort(x, stable=True)[0]


def sort_kv(k, v):
    s, idx = torch.sort(k, stable=True)
    return s, v[idx]


def gather(x, perm):
    return x[perm]


def scatter(x, perm):
    out = torch.empty_like(x)
    out[perm] = x
    return out


def onehot_permute(onehot, x):
    """out[b, i] = sum_j onehot[b, i, j] * x[b, j], in bfloat16 (float32
    accumulation)."""
    return torch.bmm(onehot, x[..., None])[..., 0]


def onehot(p: torch.Tensor, B: int) -> torch.Tensor:
    """bfloat16 one-hot rows of p (nb, B): (nb, B, B)."""
    out = torch.zeros((*p.shape, B), dtype=torch.bfloat16, device=p.device)
    return out.scatter_(2, p[..., None], 1.0)


def flat_inputs(n: int, seed: int, device):
    """Biased int32 keys, an int32 iota and a random permutation (int64)."""
    dev = interop.resolve_device(device)
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return (common.bias_i32(interop.from_numpy(keys.view(np.int32), dev)),
            torch.arange(n, dtype=torch.int32, device=dev),
            interop.from_numpy(rng.permutation(n), dev))


def onehot_inputs(n: int, B: int, seed: int, device):
    """bfloat16 blocks (n/B, B) of integers below 256, and a random column
    of each row (n/B, B) int64, as the JAX script draws them."""
    dev = interop.resolve_device(device)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n // B, B)).astype(np.float32)
    p = rng.integers(0, B, (n // B, B))
    return (interop.from_numpy(x, dev).to(torch.bfloat16), interop.from_numpy(p, dev))


def window_perm(n: int, seed: int, device, window: int = WINDOW) -> torch.Tensor:
    """Indices random inside aligned windows of `window`."""
    rng = np.random.default_rng(seed)
    base = np.arange(n, dtype=np.int64) // window * window
    return interop.from_numpy(base + rng.integers(0, window, n), device)


def cases(device, sizes=SIZES, onehot_n=ONEHOT_N, blocks=BLOCKS, gather_n=GATHER_N, seed=0):
    """Every row: (tag, fn, args, elements, bytes moved or None)."""
    out = []
    for n in sizes:
        k, v, perm = flat_inputs(n, seed, device)
        out += [("elementwise +1 (roofline)", add_one, (k,), n, 8 * n),
                ("torch.sort stable keys-only", sort_keys, (k,), n, None),
                ("torch.sort stable k+v (gather v)", sort_kv, (k, v), n, None),
                ("gather x[perm] (random)", gather, (k, perm), n, 12 * n),
                ("scatter out[perm] = x (random)", scatter, (k, perm), n, 12 * n)]
    for B in blocks:
        x, p = onehot_inputs(onehot_n, B, seed, device)
        out.append((f"one-hot matmul permute B={B} (bf16)", onehot_permute,
                    (onehot(p, B), x), onehot_n, None))
    k, _, _ = flat_inputs(gather_n, seed, device)
    out += [("gather x[iota] (coalesced)", gather,
             (k, torch.arange(gather_n, device=k.device)), gather_n, 12 * gather_n),
            (f"gather x[window-random-{WINDOW}]", gather,
             (k, window_perm(gather_n, seed, k.device)), gather_n, 12 * gather_n)]
    return out


def expected(fn, args):
    """The numpy result of a row, from its inputs."""
    a = [interop.to_numpy(x) for x in args]
    if fn is add_one:
        return a[0] + np.int32(1)
    if fn is sort_keys:
        return np.sort(a[0], kind="stable")
    if fn is sort_kv:
        order = np.argsort(a[0], kind="stable")
        return a[0][order], a[1][order]
    if fn is gather:
        return a[0][a[1]]
    if fn is scatter:
        out = np.empty_like(a[0])
        out[a[1]] = a[0]
        return out
    # one-hot (bfloat16 as its bit patterns): each output is the one element
    # of its row that the one-hot selects, exactly (1 * x + 0s, x < 256)
    return np.take_along_axis(a[1], np.argmax(a[0] != 0, axis=2), axis=1)


def check(device="cuda", sizes=CHECK_SIZES, onehot_n=CHECK_ONEHOT_N, blocks=BLOCKS,
          gather_n=CHECK_SIZES[0], seed=0) -> int:
    """Every row against numpy on the same inputs, byte for byte, at sizes
    whose numpy results the host computes quickly. Raises on a
    difference; returns 0."""
    for tag, fn, args, n, _ in cases(device, sizes, onehot_n, blocks, gather_n, seed):
        got = fn(*args)
        got = tuple(got) if isinstance(got, tuple) else (got,)
        want = expected(fn, args)
        want = want if isinstance(want, tuple) else (want,)
        if not all(np.array_equal(interop.to_numpy(g), w) for g, w in zip(got, want)):
            raise AssertionError(f"{tag} at n = {n} differs from numpy")
    return 0


def main(device="cuda", seed=0) -> list[dict]:
    """Time every row; print and return a row each, with the bytes' rate
    and bound where the row moves a known number of bytes."""
    rows = []
    for tag, fn, args, n, n_bytes in cases(device, seed=seed):
        ms = device_time(fn, *args) * 1e3
        row = {"probe": "explore_primitives", "case": tag, "n": n, "ms": ms}
        line = f"{tag:40s} n={n:>9d}  {ms:8.3f} ms  {n / ms / 1e6:7.2f} Gelem/s"
        if n_bytes:
            row.update(gb_per_s=n_bytes / ms / 1e6, bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3)
            line += f"  {row['gb_per_s']:7.1f} GB/s (bound {row['bound_ms']:.4f} ms)"
        print(line, flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    check()
    main()
