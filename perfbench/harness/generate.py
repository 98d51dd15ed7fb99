"""The general generator: a cell's inputs, made on the device from the seed.

A traffic file (``traffic/<name>.json``) holds parameters only: the key
distribution (``keys/<distribution>.py``), the segment layout, if any
(``segments/<layout>.py``), and the size of the pool of distinct inputs the
window cycles through. The configuration gives the element count, the key
and value dtypes and whether the payload is the index. The same seed gives
the same inputs; each pool slot has inputs of its own.

Segment sizes come from the layout's own parameters alone (a Zipf layout
draws them from its ``sizes_seed``), and the run's seed only shuffles
their order, so every seed sorts the same set of sizes.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import registry

DTYPES = {
    "uint16": torch.uint16, "int16": torch.int16, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "uint32": torch.uint32, "int32": torch.int32,
    "float32": torch.float32, "uint64": torch.uint64, "int64": torch.int64,
    "float64": torch.float64,
}


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose of one run, from the run's seed (any
    whole number, negative or above 64 bits too) and `parts`."""
    text = ":".join(str(p) for p in (int(seed), *parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def torch_generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def pool_size(traffic: dict) -> int:
    return max(1, int(traffic.get("pool", 1)))


def segment_sizes(n: int, spec: dict, seed: int, slot: int, bench_dir=registry.BENCH_DIR):
    """The slot's segment sizes: the layout's set, in an order drawn from the seed."""
    layout = registry.module("segments", spec["layout"], bench_dir)
    sizes = np.asarray(layout.sizes(n, spec), dtype=np.int64)
    if sizes.sum() != n or (sizes < 0).any():
        raise ValueError(f"segment layout {spec['layout']!r} gave sizes that do not cover {n}")
    order = np.random.default_rng(sub_seed(seed, "segments", slot)).permutation(sizes.size)
    return sizes[order]


def global_inputs(cfg: dict, traffic: dict, seed: int, slot: int, device,
                  bench_dir=registry.BENCH_DIR) -> dict:
    """The whole input of one call: ``keys``, and ``values`` (the index)
    and ``offsets`` (int64, S + 1 bounds) where the cell has them."""
    n = int(cfg["n"])
    spec = traffic["keys"]
    dist = registry.module("keys", spec["distribution"], bench_dir)
    gen = torch_generator(device, sub_seed(seed, "keys", slot))
    out = {"keys": dist.make(gen, n, DTYPES[cfg["key_dtype"]], spec, device)}
    if cfg.get("values") == "index":
        out["values"] = torch.arange(n, dtype=torch.int32, device=device).view(
            DTYPES[cfg["value_dtype"]])
    if traffic.get("segments"):
        sizes = segment_sizes(n, traffic["segments"], seed, slot, bench_dir)
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        out["offsets"] = torch.from_numpy(offsets).to(device)
    return out


def shard(inputs: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s part of `inputs`: equal slices of the keys and values;
    offsets, which are global bounds, whole."""
    return {k: (v if k == "offsets" else torch.tensor_split(v, world)[rank].clone())
            for k, v in inputs.items()}
