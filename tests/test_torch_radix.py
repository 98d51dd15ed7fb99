"""Port parity of the radix engine's kernels (K5, K4 and K6 through their
plain versions on the CPU): the digit histogram, bucket offsets, one
reorder pass and `sort_u32` pass counts byte-exact (tolerance 0, integer
work) against the JAX package (Pallas in interpret mode, `block_rows=16`,
i.e. 2048-key blocks, the port's tile here), and the plain versions
against numpy at every digit width (2, 4, 6, 8 bits), with `sort_u32`'s
width rule (8-bit passes, a narrower last digit) against numpy's stable
argsort. Three JAX compilations, each at n <= 8192; the rest is held
against golden and the plain versions. `sort(method='radix')` is in
`test_torch_radix_sort.py` (shared helpers: `torch_radix_helpers.py`)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_radix_sort_torch as trt
from tpu_radix_sort.ops import radix as jradix
from tpu_radix_sort_torch.ops import radix

from torch_radix_helpers import BLOCK_ROWS, TILE, _eq, _i32, _u32


@functools.cache
def _jax_fns():
    """jit with `bit` traced, so every bit shares one compilation."""
    hist = jax.jit(lambda u, b: jradix.digit_histogram(u, bit=b, block_rows=BLOCK_ROWS))
    reorder = jax.jit(lambda a, o, b: jradix._reorder_pass(
        a, o, bit=b, block_rows=BLOCK_ROWS, interpret=True))
    sort_u32 = jax.jit(lambda k: jradix.sort_u32(
        k, (), check_order=True, block_rows=BLOCK_ROWS, return_passes=True))
    return hist, reorder, sort_u32


def test_histogram_and_offsets_match_jax():
    rng = np.random.default_rng(0)
    u = _u32(rng, 64 * 128)
    hist_fn = _jax_fns()[0]
    for bit in (0, 8, 30):
        want = np.asarray(hist_fn(jnp.asarray(u).reshape(64, 128), bit))
        got = radix.digit_histogram(_i32(u), bit=bit, tile=TILE)
        assert got.shape == (4, 4) and _eq(got, want)
        if bit == 30:
            offs = radix.bucket_offsets(got)
            assert _eq(offs, np.asarray(jradix.bucket_offsets(jnp.asarray(want))))


def test_reorder_pass_matches_jax():
    rng = np.random.default_rng(1)
    k = _u32(rng, 64 * 128)
    k[::5] = k[0]  # duplicates: stability inside and across blocks
    v = np.arange(64 * 128, dtype=np.uint32)
    x = torch.stack([_i32(k), _i32(v)])
    _, reorder_fn, _ = _jax_fns()
    for bit in (0, 30):
        offs = radix.bucket_offsets(radix.digit_histogram(x[0], bit=bit, tile=TILE))
        want = reorder_fn((jnp.asarray(k).reshape(64, 128), jnp.asarray(v).reshape(64, 128)),
                          jnp.asarray(offs.numpy().view(np.uint32)), bit)
        got = radix.reorder_pass(x, offs, bit=bit, tile=TILE)
        assert _eq(got, np.stack([np.asarray(w).reshape(-1) for w in want]))


def test_sort_u32_pass_counts_match_jax():
    """The three cases of the JAX package's mid-sort early-exit test:
    keys < 16 stop after 2 passes, sorted keys after 0, random keys run 16."""
    rng = np.random.default_rng(2)
    small = _u32(rng, 4000, 16)
    sort_fn = _jax_fns()[2]
    for k, want_run in ((small, 2), (np.sort(small), 0), (_u32(rng, 4000), 16)):
        jk, _, j_run = sort_fn(jnp.asarray(k))
        out, rest, n_run = radix.sort_u32(_i32(k), check_order=True, tile=TILE,
                                          return_passes=True)
        assert n_run == int(j_run) == want_run
        assert rest == () and _eq(out, np.asarray(jk)) and _eq(out, np.sort(k))


def test_output_does_not_depend_on_tile():
    rng = np.random.default_rng(4)
    n = 5000
    k = _u32(rng, n, 1 << 12)
    cols = [_i32(k), _i32(_u32(rng, n)), _i32(np.arange(n, dtype=np.uint32))]
    outs = [radix.sort_u32(cols[0], tuple(cols[1:]), bit_count=12, tile=t)
            for t in (128, 256, 512, 1024, 2048, 4096, 8192)]
    for keys, rest in outs[1:]:
        assert torch.equal(keys, outs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(rest, outs[0][1]))
    order = np.argsort(k & np.uint32(0xFFF), kind="stable")
    assert _eq(outs[0][0], k[order]) and _eq(outs[0][1][1], order.astype(np.uint32))
    x = torch.stack(cols)
    passes = []
    for t in (128, 1024, 8192):
        offs = radix.bucket_offsets(radix.digit_histogram(x[0], bit=6, tile=t))
        passes.append(radix.reorder_pass(x, offs, bit=6, tile=t))
    assert all(torch.equal(p, passes[0]) for p in passes[1:])


@pytest.mark.parametrize("digit_bits", [2, 8])
@pytest.mark.parametrize("pattern", [0, 0xFFFFFFFF, 0xAAAAAAAA, 0x55555555])
def test_all_equal_keys_are_stable(pattern, digit_bits):
    """Every key in one digit run at every pass: the runs span whole tiles.
    The sort runs its 4 passes of 8 bits; K5 and a K6 pass are driven
    directly at both widths."""
    n = 3 * 1024 + 7
    k = np.full(n, pattern, np.uint32)
    v = np.arange(n, dtype=np.uint32)[::-1].copy()
    out, (ov,), n_run = radix.sort_u32(_i32(k), (_i32(v),), tile=1024, return_passes=True)
    assert n_run == 4 and _eq(out, k) and _eq(ov, v)
    hist = radix.digit_histogram(_i32(k), bit=4, tile=1024, digit_bits=digit_bits)
    digit = (pattern >> 4) & ((1 << digit_bits) - 1)
    assert hist[digit].tolist() == [1024, 1024, 1024, 7] and int(hist.sum()) == n
    x = torch.stack([_i32(k), _i32(v)])
    got = radix.reorder_pass(x, radix.bucket_offsets(hist), bit=4, tile=1024,
                             digit_bits=digit_bits)
    assert torch.equal(got, x)


def test_plain_versions_match_numpy():
    rng = np.random.default_rng(5)
    n, tile, bit = 1000, 128, 14  # a ragged last tile of 104 keys
    k = _u32(rng, n)
    dig = (k >> bit) & 3
    hist = radix.digit_histogram_plain(_i32(k), bit=bit, tile=tile).numpy()
    blocks = np.arange(n) // tile
    want = np.zeros((4, 8), np.int64)
    np.add.at(want, (dig, blocks), 1)
    assert np.array_equal(hist, want)
    offs = radix.bucket_offsets(torch.from_numpy(hist))
    x = torch.stack([_i32(k), _i32(np.arange(n, dtype=np.uint32))])
    out = radix.reorder_pass_plain(x, offs, bit=bit, tile=tile, out=torch.empty_like(x))
    order = np.argsort(dig, kind="stable")
    assert _eq(out, np.stack([k[order], order.astype(np.uint32)]))


@pytest.mark.parametrize("keys", ["all-equal", "random"])
def test_reorder_plain_at_the_largest_tile(keys):
    """One tile of 2^16 and a ragged last tile of 5: with all-equal keys
    one digit run fills the whole tile (K6 counts it in 32 bits)."""
    rng = np.random.default_rng(6)
    n, tile = (1 << 16) + 5, 1 << 16
    k = np.full(n, 0xDEADBEEF, np.uint32) if keys == "all-equal" else _u32(rng, n)
    cols = np.stack([k, _u32(rng, n), np.arange(n, dtype=np.uint32)])
    x = _i32(cols)
    for bit in (0, 2, 16, 30):
        hist = radix.digit_histogram_plain(x[0], bit=bit, tile=tile)
        out = radix.reorder_pass_plain(x, radix.bucket_offsets(hist), bit=bit, tile=tile,
                                       out=torch.empty_like(x))
        order = np.argsort((k >> np.uint32(bit)) & np.uint32(3), kind="stable")
        assert _eq(out, cols[:, order])


def test_input_errors():
    x = torch.zeros((2, 100), dtype=torch.int32)
    offs = radix.bucket_offsets(radix.digit_histogram(x[0], bit=0, tile=64))
    cases = [
        (ValueError, lambda: radix.digit_histogram(x[0], bit=0, tile=48)),
        (ValueError, lambda: radix.digit_histogram(x[0], bit=0, tile=16)),
        (ValueError, lambda: radix.digit_histogram(x[0], bit=0, tile=1 << 17)),
        (ValueError, lambda: radix.digit_histogram(x[0], bit=31, tile=64)),
        (TypeError, lambda: radix.digit_histogram(x[0].long(), bit=0)),
        (ValueError, lambda: radix.digit_histogram(x, bit=0)),
        (ValueError, lambda: radix.reorder_pass(x, offs, bit=0, tile=128)),
        (ValueError, lambda: radix.reorder_pass(x, offs[:, :1], bit=0, tile=64)),
        (ValueError, lambda: radix.reorder_pass(x, offs, bit=0, tile=64, out=x)),
        (ValueError, lambda: radix.reorder_pass(torch.zeros((7, 100), dtype=torch.int32),
                                                offs, bit=0, tile=64)),
        (TypeError, lambda: radix.reorder_pass(x.long(), offs, bit=0, tile=64)),
        (ValueError, lambda: radix.sort_u32(x[0], (x[1],) * 6)),
        (ValueError, lambda: radix.sort_u32(x[0], (x[1, :50],))),
        (ValueError, lambda: radix.sort_u32(x[0], bit_count=7)),
        (ValueError, lambda: trt.sort(np.zeros(8, np.uint32), method="radix", tile=100,
                                      device="cpu")),
        (ValueError, lambda: radix.digit_histogram(x[0], bit=0, tile=64, digit_bits=3)),
        (ValueError, lambda: radix.digit_histogram(x[0], bit=25, tile=64, digit_bits=8)),
        (ValueError, lambda: radix.reorder_pass(x, offs, bit=0, tile=64, digit_bits=8)),
        (ValueError, lambda: radix.reorder_pass(x, offs, bit=0, tile=64, digit_bits=10)),
    ]
    for exc, fn in cases:
        with pytest.raises(exc):
            fn()


def _stable_order(k, bit_count):
    mask = np.uint32((1 << bit_count) - 1) if bit_count < 32 else np.uint32(0xFFFFFFFF)
    return np.argsort(k & mask, kind="stable")


@pytest.mark.parametrize("digit_bits", [2, 4, 6, 8])
@pytest.mark.parametrize("tile", [128, 1024])
def test_plain_versions_match_numpy_at_every_width(digit_bits, tile):
    """K5 and K6's plain versions at each width against numpy: the
    digit-major table of each tile, and the stable split by digit within
    tiles placed at the scanned offsets (a ragged last tile, a hot digit in
    half the keys)."""
    rng = np.random.default_rng(10 + digit_bits)
    n, buckets = 5 * tile + 37, 1 << digit_bits
    k = _u32(rng, n)
    k[rng.random(n) < 0.5] &= np.uint32(~(((1 << digit_bits) - 1) << 7) & 0xFFFFFFFF)
    for bit in (0, 7, 32 - digit_bits):
        dig = ((k >> np.uint32(bit)) & np.uint32(buckets - 1)).astype(np.int64)
        blocks = np.arange(n) // tile
        want = np.zeros((buckets, blocks[-1] + 1), np.int64)
        np.add.at(want, (dig, blocks), 1)
        hist = radix.digit_histogram(_i32(k), bit=bit, tile=tile, digit_bits=digit_bits)
        assert np.array_equal(hist.numpy(), want)
        offs = radix.bucket_offsets(hist)
        x = torch.stack([_i32(k), _i32(np.arange(n, dtype=np.uint32))])
        out = radix.reorder_pass(x, offs, bit=bit, tile=tile, digit_bits=digit_bits)
        flat = np.cumsum(want.reshape(-1)) - want.reshape(-1)  # digit-major offsets
        dest = np.empty(n, np.int64)
        for b in range(want.shape[1]):
            idx = np.nonzero(blocks == b)[0]
            for r in np.unique(dig[idx]):
                mine = idx[dig[idx] == r]
                dest[mine] = flat[r * want.shape[1] + b] + np.arange(mine.size)
        expect = np.empty((2, n), np.uint32)
        expect[:, dest] = np.stack([k, np.arange(n, dtype=np.uint32)])
        assert _eq(out, expect)
        assert _eq(out[0], k[np.argsort(dig, kind="stable")])


@pytest.mark.parametrize("bit_count,n_cols,tile", [
    (2, 1, None), (4, 2, 128), (8, 3, 1024), (12, 4, None), (16, 5, 4096),
    (30, 6, 1 << 16), (32, 1, 128), (32, 2, None), (32, 3, 1 << 16), (32, 6, 4096),
    (16, 1, 1 << 12), (30, 2, 256), (12, 6, 1 << 15), (8, 5, None),
])
def test_sort_u32_width_rule_matches_numpy(bit_count, n_cols, tile):
    """sort_u32 without the order check, 8-bit passes and a narrower last
    digit, byte for byte against numpy's stable argsort of the masked keys,
    every payload column carried; a partial last tile at every tile; the
    passes counted by width."""
    rng = np.random.default_rng(bit_count * 16 + n_cols)
    n = 3 * (tile or 4096) + 1001
    k = _u32(rng, n)
    k[::3] = k[5]  # long runs of one key: stability across tiles
    pays = [_u32(rng, n) for _ in range(n_cols - 1)]
    widths = radix.digit_widths(bit_count)
    assert sum(widths) == bit_count and all(w == 8 for w in widths[:-1])
    before = radix.pass_counts()
    out, rest, n_run = radix.sort_u32(_i32(k), tuple(_i32(p) for p in pays),
                                      bit_count=bit_count, tile=tile, return_passes=True)
    after = radix.pass_counts()
    assert n_run == len(widths) == (bit_count + 7) // 8
    assert {w: after[w] - before[w] for w in after} == {
        w: widths.count(w) for w in radix.DIGIT_BITS}
    order = _stable_order(k, bit_count)
    assert _eq(out, k[order]) and _eq(rest, tuple(p[order] for p in pays))


@pytest.mark.parametrize("keys", ["all-equal", "hot-digit", "one-key-per-tile"])
@pytest.mark.parametrize("tile", [128, 4096, 1 << 16])
def test_sort_u32_wide_passes_on_skewed_keys(keys, tile):
    """The cases a 256-way rank is likeliest to get wrong: one digit run
    for all keys, one hot 8-bit digit in 90% of the keys at every pass (the
    entropy cell's skew, and worse), and a tile that ends mid-run."""
    rng = np.random.default_rng(len(keys) + tile)
    n = 2 * tile + 77
    if keys == "all-equal":
        k = np.full(n, 0x12345678, np.uint32)
    elif keys == "hot-digit":
        k = _u32(rng, n)
        hot = rng.random((n, 4)) < 0.9
        for byte in range(4):
            k[hot[:, byte]] &= np.uint32(~(0xFF << (8 * byte)) & 0xFFFFFFFF)
    else:
        k = np.repeat(_u32(rng, n // tile + 1), tile)[:n]
    v = np.arange(n, dtype=np.uint32)
    out, (ov,) = radix.sort_u32(_i32(k), (_i32(v),), tile=tile)
    order = np.argsort(k, kind="stable")
    assert _eq(out, k[order]) and _eq(ov, order.astype(np.uint32))


def test_width_rule_and_default_tile():
    """The widths read only bit_count and check_order; a wider digit's
    default tile keeps its table within MAX_TABLE_ENTRIES (2 MiB with its
    offsets at 2^26 keys)."""
    assert radix.digit_widths(32) == [8, 8, 8, 8]
    assert radix.digit_widths(16) == [8, 8]
    assert radix.digit_widths(12) == [8, 4]
    assert radix.digit_widths(4) == [4]
    assert radix.digit_widths(30) == [8, 8, 8, 6]
    assert radix.digit_widths(0) == []
    assert radix.digit_widths(32, check_order=True) == [2] * 16
    assert radix.default_tile(1 << 26, 2) == radix.DEFAULT_TILE
    assert radix.default_tile(1000, 8) == radix.DEFAULT_TILE
    for n in (1 << 20, 30_000_000, 1 << 26):
        t = radix.default_tile(n, 8)
        assert 256 * (-(-n // t)) <= radix.MAX_TABLE_ENTRIES
        assert t == radix.DEFAULT_TILE or radix.MAX_TABLE_ENTRIES < 256 * (-(-n // (t // 2)))
    assert 2 * 4 * 256 * ((1 << 26) // radix.default_tile(1 << 26, 8)) <= 4 << 20
    assert radix.default_tile(1 << 30, 8) == radix.MAX_TILE
