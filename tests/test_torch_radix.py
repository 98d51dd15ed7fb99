"""Port parity of the radix engine (`method='radix'`; kernels K5, K4 and K6
through their plain versions on the CPU): the digit histogram, bucket
offsets, one reorder pass, `sort_u32` pass counts and `sort(method='radix')`
byte-exact (tolerance 0, integer work) against the JAX package (Pallas in
interpret mode, `block_rows=16`, i.e. 2048-key blocks, the port's tile here)
and the numpy golden. Six JAX compilations, each at n <= 4096; the rest is
held against golden and the plain versions."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_radix_sort as jtrs
import tpu_radix_sort_torch as trt
from tpu_radix_sort.ops import radix as jradix
from tpu_radix_sort_torch.models.golden import golden_sort
from tpu_radix_sort_torch.ops import radix

BLOCK_ROWS = 16
TILE = BLOCK_ROWS * 128  # one JAX block = one port tile


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _eq(got, want):
    """Byte equality of a tensor (or tuple of them) with numpy arrays."""
    if isinstance(want, tuple):
        return len(got) == len(want) and all(_eq(g, w) for g, w in zip(got, want))
    g = got.numpy()
    return g.dtype.itemsize == want.dtype.itemsize and np.array_equal(
        g.view(np.uint8), np.ascontiguousarray(want).view(np.uint8))


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


@pytest.mark.parametrize("case", ["key+value", "keys-only"])
def test_sort_radix_matches_jax(case):
    rng = np.random.default_rng(3)
    n = 3000
    if case == "key+value":
        # f32 with duplicates, NaN and -inf under total order, descending,
        # a sub-count and the mid-sort check, in one compilation
        k = (rng.integers(-40, 40, n) / 4).astype(np.float32)
        k[::37] = np.nan
        k[::41] = -np.inf
        v = _u32(rng, n)
        kw = dict(count=2222, total_order=True, descending=True)
        args = (k, v)
        extra = dict(check_order=True)
    else:
        # keys-only with bit_count < 32: the full key rides along
        k = _u32(rng, n)
        k[::3] = k[1]
        kw = dict(count=2500, bit_count=8)
        args = (k,)
        extra = {}
    want = jtrs.sort(*map(jnp.asarray, args), method="radix", block_rows=BLOCK_ROWS,
                     **kw, **extra)
    got = trt.sort(*args, method="radix", device="cpu", tile=TILE, **kw, **extra)
    want = tuple(map(np.asarray, want)) if len(args) == 2 else np.asarray(want)
    assert _eq(got, want)
    assert _eq(got, golden_sort(*args, **kw))


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


@pytest.mark.parametrize("pattern", [0, 0xFFFFFFFF, 0xAAAAAAAA, 0x55555555])
def test_all_equal_keys_are_stable(pattern):
    """Every key in one digit run at every pass: the runs span whole tiles."""
    n = 3 * 1024 + 7
    k = np.full(n, pattern, np.uint32)
    v = np.arange(n, dtype=np.uint32)[::-1].copy()
    out, (ov,), n_run = radix.sort_u32(_i32(k), (_i32(v),), tile=1024, return_passes=True)
    assert n_run == 16 and _eq(out, k) and _eq(ov, v)
    hist = radix.digit_histogram(_i32(k), bit=4, tile=1024)
    digit = (pattern >> 4) & 3
    assert hist[digit].tolist() == [1024, 1024, 1024, 7] and int(hist.sum()) == n


def test_digit_skewed_keys_with_payload():
    n = 9000
    k = (np.arange(n, dtype=np.uint32) % 4) << np.uint32(28)
    v = np.arange(n, dtype=np.uint32)
    ok, ov = trt.sort(k, v, method="radix", device="cpu", tile=128)
    assert _eq((ok, ov), golden_sort(k, v))


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
    ]
    for exc, fn in cases:
        with pytest.raises(exc):
            fn()
