"""The 3D Gaussian Splatting frame sort of the benchmark (configuration
``splat_tile_depth_u64``) on the CPU at a small size: a frame of a 12 x 8
tile grid, about 50,000 instances. The port's ``sort(keys, values,
bit_count=44)`` through every engine against the benchmark's plain
reference, the reference against NumPy, the key generator against a loop
that follows the rasterizer's ``getRect`` and ``duplicateWithKeys``, and
the Entropy 0.201 keys' bit rate."""
import math

import numpy as np
import pytest
import torch

import tpu_radix_sort_torch as trs
from perfbench.harness import generate, registry
from perfbench.reference import tile_depth_pairs as ref

CPU = torch.device("cpu")
TILE = registry.module("keys", "tile_depth")
ENTRY = registry.module("entries", "tile_depth_pairs")
# the traffic file's laws on a 192 x 128 px frame: a 12 x 8 tile grid
FRAME = dict(registry.traffic("bicycle_frame")["keys"], image_px=[192, 128], batch=4096)
N = 50_001  # not a multiple of the radix engine's 4,096-key tile
SMALL = 3_001  # below one tile


def _gen(seed):
    return generate.torch_generator(CPU, seed)


def _inputs(n, seed=7, high_bits=False):
    keys = TILE.make(_gen(seed), n, torch.uint64, FRAME, CPU)
    if high_bits:  # bits above the 44 sorted on, which must come back whole
        high = torch.randint(0, 1 << 20, (n,), generator=_gen(seed + 1)) << 44
        keys = (keys.view(torch.int64) | high).view(torch.uint64)
    return {"keys": keys, "values": torch.arange(n, dtype=torch.int32).view(torch.uint32)}


def _loop_instances(seed, n):
    """The frame's first `n` instances by a plain loop over the same draws:
    ``getRect`` in float32, truncated by int() as the source's casts, clamped to
    the grid; one instance a tile of the rectangle, row after row."""
    gx, gy = TILE.grid(FRAME)
    t = np.float32(FRAME["tile_px"])
    gen, out = _gen(seed), []
    while len(out) < n:
        px, py, radius, depth = (a.numpy() for a in TILE.gaussians(gen, FRAME["batch"], FRAME, CPU))
        for g in range(px.size):
            r = np.float32(radius[g])
            x0, y0 = (min(lim, max(0, int((p - r) / t)))
                      for p, lim in ((px[g], gx), (py[g], gy)))
            x1, y1 = (min(lim, max(0, int((p + r + t - np.float32(1)) / t)))
                      for p, lim in ((px[g], gx), (py[g], gy)))
            out += [(y * gx + x, depth[g]) for y in range(y0, y1) for x in range(x0, x1)]
    tiles, depths = zip(*out[:n])
    return np.array(tiles), np.array(depths, dtype=np.float32)


def test_generator_follows_get_rect_and_duplicate_with_keys():
    tile, depth, gaussian = TILE.instances(_gen(5), N, FRAME, CPU)
    want_tile, want_depth = _loop_instances(5, N)
    assert np.array_equal(tile.numpy(), want_tile)
    assert np.array_equal(depth.numpy(), want_depth)
    # Gaussian-major; within a Gaussian one depth and its tiles row-major
    same = gaussian[1:] == gaussian[:-1]
    assert bool((gaussian[1:] >= gaussian[:-1]).all())
    assert bool((tile[1:] > tile[:-1])[same].all()) and bool((depth[1:] == depth[:-1])[same].all())
    keys = TILE.make(_gen(5), N, torch.uint64, FRAME, CPU).view(torch.int64)
    assert torch.equal(keys >> 32, tile)
    assert torch.equal(keys & 0xFFFFFFFF, depth.view(torch.int32).to(torch.int64))


def test_generator_is_deterministic_and_within_the_frame():
    a, b = (TILE.make(_gen(11), N, torch.uint64, FRAME, CPU).view(torch.int64) for _ in "ab")
    assert torch.equal(a, b)
    assert not torch.equal(a, TILE.make(_gen(12), N, torch.uint64, FRAME, CPU).view(torch.int64))
    gx, gy = TILE.grid(FRAME)
    assert (gx, gy) == (12, 8) and TILE.grid(registry.traffic("bicycle_frame")["keys"]) == (78, 52)
    tile, depth = a >> 32, (a & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    assert int(tile.min()) >= 0 and int(tile.max()) < gx * gy
    assert bool((depth >= torch.tensor(0.2)).all()) and bool((depth <= 100).all())
    # narrower dtypes take the words' low bytes
    low = TILE.make(_gen(11), N, torch.uint32, FRAME, CPU)
    assert torch.equal(low.view(torch.int32), (a & 0xFFFFFFFF).to(torch.int32))


@pytest.mark.parametrize("method", ["radix", "bitonic", "auto"])
@pytest.mark.parametrize("n", [N, SMALL])
def test_port_matches_the_plain_reference(method, n):
    inputs = _inputs(n, high_bits=True)
    keys, values = trs.sort(inputs["keys"], inputs["values"], bit_count=ref.BIT_COUNT,
                            method=method)
    assert ref.judge(inputs, {"keys": keys, "values": values}) == ref.LIMITS
    assert torch.equal(inputs["keys"].view(torch.int64).sort().values,
                       keys.view(torch.int64).sort().values)  # every key whole


def test_the_entry_calls_the_normal_path_under_auto(monkeypatch):
    seen = {}
    real = trs.sort

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(trs, "sort", spy)
    inputs = _inputs(SMALL)
    answer = ENTRY.call(trs, inputs, None)
    assert seen == {"bit_count": ref.BIT_COUNT} and ENTRY.BIT_COUNT == ref.BIT_COUNT
    assert ref.judge(inputs, answer) == ref.LIMITS


def test_reference_is_numpys_stable_sort_and_its_control_fails():
    inputs = _inputs(N, seed=3, high_bits=True)
    keys = inputs["keys"].view(torch.int64).numpy()
    values = inputs["values"].view(torch.int32).numpy()
    order = np.argsort(keys & ((1 << 44) - 1), kind="stable")
    got = ref.expected(inputs)
    assert np.array_equal(got["keys"].view(torch.int64).numpy(), keys[order])
    assert np.array_equal(got["values"].view(torch.int32).numpy(), values[order])
    bad = ref.judge(inputs, ref.control(inputs))
    assert bad["key_mismatches"] > 0 and bad["value_mismatches"] > 0


def test_entropy_keys_set_each_bit_at_one_in_32():
    n = 1 << 16
    keys = registry.module("keys", "entropy").make(
        _gen(9), n, torch.uint32, registry.traffic("entropy0201")["keys"], CPU)
    bits = (keys.view(torch.int32).to(torch.int64)[:, None] >> torch.arange(32)) & 1
    p = 1 / 32
    sigma = math.sqrt(n * p * (1 - p))
    assert bool(((bits.sum(0) - n * p).abs() <= 4 * sigma).all())
