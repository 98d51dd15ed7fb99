"""Port parity of the bitonic engine (kernel K1's plain version on the CPU):
`sort_padded` / `merge_padded` byte-exact against the JAX package (Pallas in
interpret mode, small `block_rows` so merge rounds run) and against numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_radix_sort.ops import bitonic as jbitonic
from tpu_radix_sort_torch.ops import bitonic
from tpu_radix_sort_torch.utils import interop


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _port(cols, fn, **kw):
    out = fn(tuple(interop.from_numpy(c, "cpu") for c in cols), **kw)
    return [interop.to_numpy(o) for o in out]


def _jax(cols, fn, **kw):
    return [np.asarray(o) for o in fn(tuple(jnp.asarray(c) for c in cols), **kw)]


def test_sort_padded_keys_only_matches_jax():
    rng = np.random.default_rng(0)
    k = _u32(rng, 512, 300)
    k[rng.integers(0, 512, 40)] = 0xFFFFFFFF  # real max keys among the data
    want = _jax([k], jbitonic.sort_padded, stable=False, block_rows=1)  # T = 128
    for tile in (128, 32):
        got = _port([k], bitonic.sort_padded, stable=False, tile=tile)
        assert np.array_equal(got[0], want[0]), tile


def test_sort_padded_stable_with_payload_matches_jax():
    rng = np.random.default_rng(1)
    n = 256
    k = _u32(rng, n, 20)
    k[-40:] = 0xFFFFFFFF  # sentinel pads: identical (key, tie, payload) tuples
    tie = np.arange(n, dtype=np.uint32)
    tie[-40:] = 0xFFFFFFFF
    p = _u32(rng, n)
    p[-40:] = 0
    cols = [k, tie, p]
    want = _jax(cols, jbitonic.sort_padded, stable=True, block_rows=1)  # T = 128
    got = _port(cols, bitonic.sort_padded, stable=True, tile=64)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_merge_padded_matches_jax():
    rng = np.random.default_rng(2)
    a = np.sort(_u32(rng, 512, 1000))
    b = np.sort(_u32(rng, 512, 1000))[::-1]
    k = np.concatenate([a, b])  # bitonic: ascending ++ descending
    want = _jax([k], jbitonic.merge_padded, stable=False, block_rows=2)
    got = _port([k], bitonic.merge_padded, stable=False, tile=256)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[0], np.sort(k))


@pytest.mark.parametrize("n_arr,n_keys", [
    (1, 1), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3), (4, 1), (4, 2), (4, 3),
    (5, 1), (5, 2), (5, 3),
])
def test_column_configs_match_numpy(n_arr, n_keys):
    rng = np.random.default_rng(10 * n_arr + n_keys)
    n = 1024
    cols = [_u32(rng, n) for _ in range(n_arr)]
    cols[0] = _u32(rng, n, 8)  # heavy duplicates in the leading key
    # distinct key tuples: the last key column is unique (a shuffled index),
    # or, with one key column and payloads, the key itself
    cols[n_keys - 1] = rng.permutation(n).astype(np.uint32) * np.uint32(4099)
    got = _port(cols, bitonic.sort_padded, stable=n_keys > 1, tile=64,
                n_keys=n_keys)
    order = np.lexsort(cols[:n_keys][::-1])
    for g, c in zip(got, cols):
        assert np.array_equal(g, c[order])


def test_output_does_not_depend_on_tile():
    rng = np.random.default_rng(3)
    n = 2048
    cols = [_u32(rng, n, 50), np.arange(n, dtype=np.uint32), _u32(rng, n)]
    outs = [_port(cols, bitonic.sort_padded, stable=True, tile=t)
            for t in (2, 16, 256, 2048)]
    for o in outs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(o, outs[0]))
    # every tile runs the same network: the schedule's stages, in order,
    # are the full bitonic stage list
    for t in (2, 16, 256, 2048):
        flat = []
        for call in bitonic.sort_schedule(n, t):
            flat += call[1] if call[0] == "tile" else [call[1:]]
        assert flat == bitonic._block_stages(2, n)
        assert all(j >= t for c in bitonic.sort_schedule(n, t) if c[0] == "global"
                   for j in [c[2]])


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        bitonic.tile_stages(x, [(256, 128)], n_keys=1, tile=128)  # j >= tile
    with pytest.raises(ValueError):
        bitonic.tile_stages(x, [(4, 1)] * 129, n_keys=1, tile=128)
    with pytest.raises(TypeError):
        bitonic.tile_stages(x.to(torch.int64), [(2, 1)], n_keys=1, tile=128)
    with pytest.raises(ValueError):
        bitonic.global_stage(x.t(), 4, 2, n_keys=1)  # not contiguous
    with pytest.raises(ValueError):
        bitonic.global_stage(x, 4, 256, n_keys=1)  # 2j > n
    with pytest.raises(ValueError):
        bitonic.global_stage(torch.zeros((6, 256), dtype=torch.int32), 4, 2, n_keys=1)
    with pytest.raises(ValueError):
        bitonic.global_stage(x, 4, 2, n_keys=3)
    with pytest.raises(ValueError):
        bitonic.sort_padded((torch.zeros(96, dtype=torch.int32),), stable=False)
    with pytest.raises(ValueError):
        bitonic.sort_padded((torch.zeros(256, dtype=torch.int32),), stable=False,
                            tile=3)
    with pytest.raises(ValueError):  # 5 columns of a 2^14 tile overflow 227 KB
        bitonic.resolve_tile(1 << 20, 5, 1 << 14)
