"""K1-K6 on the CUDA card against their plain PyTorch versions, and the
sort engines on the card against golden and `torch.sort`, for 32-, 64- and
16-bit keys; the row-local K1 schedule, and the batched and segmented
sorts against golden; the probe kernels (P1-P9 of
`tpu_radix_sort_torch/benchmarks`) against their plain versions, and the
16-bit counting sorts against `torch.sort`.

Marked `gpu`; each test asks the `cuda` fixture for the card and skips where
there is none. On a CUDA machine without JAX, run them apart from the rest of
the suite (tests/conftest.py imports JAX):

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""
import numpy as np
import pytest
import torch

import tpu_radix_sort_torch as trt
from tpu_radix_sort_torch import _build
from tpu_radix_sort_torch.benchmarks import (explore_blocksort, explore_ce, explore_keys16,
                                             explore_scan)
from tpu_radix_sort_torch.models.golden import golden_sort
from tpu_radix_sort_torch.ops import bitonic, checksort, radix, scan
from tpu_radix_sort_torch.ops import sort as sort_mod
from tpu_radix_sort_torch.utils import dispatch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _columns(rng, n_arr, n_keys, n):
    """Random (n_arr, n) int32 columns: a low-entropy key (duplicates) and,
    below it, a unique tie so sorted tuples are distinct."""
    x = rng.integers(-2**31, 2**31, (n_arr, n), dtype=np.int64).astype(np.int32)
    x[0] = rng.integers(0, 64, n).astype(np.int32)
    if n_keys >= 2:
        x[n_keys - 1] = rng.permutation(n).astype(np.int32)
    return torch.from_numpy(x)


_COLUMN_CONFIGS = [
    (1, 1), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3), (5, 2), (5, 3),
    (6, 3), (7, 2), (7, 3), (4, 4), (5, 4), (6, 4), (7, 4), (8, 1), (8, 2), (8, 3), (8, 4),
]


@pytest.mark.parametrize("n_arr,n_keys,tile", [
    (a, k, t) for a, k in _COLUMN_CONFIGS
    for t in (2, 32, 128, 1024, 1 << 12, 1 << 14) + (((1 << 15),) if a == 1 else ())
    if a * t * 4 <= dispatch.SMEM_BUDGET_BYTES and (t != 1 << 12 or a >= 4)
])
def test_bitonic_kernels_match_plain(cuda, n_arr, n_keys, tile):
    """Every call of a sort's schedule, tiles below one warp's 1,024
    elements (a chunk of several tiles, the array shorter than a chunk at
    tile 2) up to the largest tile the columns fit."""
    rng = np.random.default_rng(10 * n_arr + n_keys + tile)
    n = 2 * max(tile, 256)
    x = _columns(rng, n_arr, n_keys, n).to(cuda)
    before = _build.launch_counts()
    for call in bitonic.sort_schedule(n, tile):
        got = bitonic.run_schedule(x.clone(), [call], n_keys=n_keys, tile=tile)
        stages = call[1] if call[0] == "tile" else [call[1:]]
        want = bitonic.stages_plain(x.clone(), stages, n_keys)
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
        x = got
    after = _build.launch_counts()
    assert after["bitonic_tile_kernel"] > before["bitonic_tile_kernel"]
    assert after["bitonic_global_stage_kernel"] > before["bitonic_global_stage_kernel"]
    keys = x[:n_keys].cpu().numpy().view(np.uint32)
    # sorted key tuples: a stable lexsort leaves them where they are
    assert np.array_equal(np.lexsort(keys[::-1]), np.arange(n))


@pytest.mark.parametrize("kind", ["sorted", "reversed", "random", "short"])
def test_disorder_kernel_matches_plain(cuda, kind):
    rng = np.random.default_rng(7)
    n = 3 if kind == "short" else (1 << 20) + 3
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if kind == "sorted":
        u.sort()
    elif kind == "reversed":
        u = np.sort(u)[::-1].copy()
    t = torch.from_numpy(u.view(np.int32)).to(cuda)
    before = _build.DISORDER.launches
    got = checksort.disorder_kernel(t)
    assert _build.DISORDER.launches == before + 1
    want = checksort.disorder_plain(t)
    assert torch.equal(got, want)
    assert int(got) == int(np.count_nonzero(u[:-1] > u[1:]))


def test_sort_on_card_matches_golden(cuda, monkeypatch):
    monkeypatch.setattr(sort_mod, "SPLIT_MIN_N", 1 << 12)
    rng = np.random.default_rng(3)
    for n in (5000, 100_000):
        k = rng.integers(0, n // 8, n, dtype=np.uint64).astype(np.uint32)
        k[rng.integers(0, n, 50)] = 0xFFFFFFFF
        v = np.arange(n, dtype=np.uint32)
        for kw in ({}, {"values_are_ranks": True}, {"bit_count": 8},
                   {"descending": True}, {"count": n // 3}, {"check_order": True}):
            ok, ov = trt.sort(k, v, device=cuda, tile=512, method="bitonic", **kw)
            gk, gv = golden_sort(k, v, **{a: b for a, b in kw.items()
                                          if a in ("bit_count", "descending", "count")})
            assert np.array_equal(ok.cpu().numpy(), gk), (n, kw)
            assert np.array_equal(ov.cpu().numpy(), gv), (n, kw)
        assert np.array_equal(trt.sort(k, device=cuda, method="bitonic").cpu().numpy(),
                              golden_sort(k))
        assert trt.is_sorted(np.sort(k), device=cuda)
        assert not trt.is_sorted(k, device=cuda)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 16383, 16384, 16385, 65536,
                               (1 << 22) + 3])
@pytest.mark.parametrize("inclusive", [False, True])
def test_scan_kernel_matches_plain(cuda, n, inclusive):
    """One launch per call, whatever n; inputs at a 4-byte offset (scalar
    loads) and lengths that are no multiple of 4; at 2^22 + 3 ten calls in
    a row, each compared, to catch a look-back race."""
    rng = np.random.default_rng(n)
    u = rng.integers(0, 2**32, n + 1, dtype=np.uint64).astype(np.uint32)
    whole = torch.from_numpy(u.view(np.int32)).to(cuda)
    for t in (whole[:n], whole[1:]):
        for _ in range(10 if n > 1 << 22 else 1):
            before = _build.SCAN.launches
            got = scan.scan_kernel(t, inclusive=inclusive)
            assert _build.SCAN.launches == before + 1
            assert torch.equal(got, scan.scan_plain(t, inclusive=inclusive))
    assert torch.equal(trt.prefix_sum(whole[1:].view(torch.uint32), inclusive=inclusive)
                       .view(torch.int32), scan.scan_plain(whole[1:], inclusive=inclusive))


@pytest.mark.parametrize("n_arr", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("tile", [32, 128, 256, 4096, 1 << 16])
@pytest.mark.parametrize("keys", ["random", "all-equal"])
def test_radix_kernels_match_plain(cuda, n_arr, tile, keys):
    """K5 and K6 against their plain versions, one launch each per pass.
    Tiles below K6's 4,096-element chunk (32 and 128: one warp, part of its
    items empty) and above it (2^16: 16 chunks a block); n = 1,000 is below
    one chunk, and 2^18 + 3 leaves a last tile of 3 keys, shorter than a
    warp. All-equal keys put a whole tile of 2^16 in one digit run."""
    rng = np.random.default_rng(n_arr * tile + (keys == "all-equal"))
    for n in (1000, (1 << 18) + 3):
        x = torch.from_numpy(rng.integers(-2**31, 2**31, (n_arr, n), dtype=np.int64)
                             .astype(np.int32)).to(cuda)
        if keys == "all-equal":
            x[0] = -0x21524111  # 0xDEADBEEF
        else:
            x[0, ::7] = 12345  # one digit run across tiles
        for bit in (0, 14, 30):
            h0, r0 = _build.DIGIT_HISTOGRAM.launches, _build.REORDER.launches
            hist = radix.digit_histogram(x[0], bit=bit, tile=tile)
            assert torch.equal(hist, radix.digit_histogram_plain(x[0], bit=bit, tile=tile))
            offs = radix.bucket_offsets(hist)
            got = radix.reorder_pass(x, offs, bit=bit, tile=tile)
            want = radix.reorder_pass_plain(x, offs, bit=bit, tile=tile,
                                            out=torch.empty_like(x))
            torch.cuda.synchronize()
            assert torch.equal(got, want), (n, bit)
            assert (_build.DIGIT_HISTOGRAM.launches, _build.REORDER.launches) == (h0 + 1, r0 + 1)


def test_radix_sort_on_card_matches_torch_sort(cuda):
    rng = np.random.default_rng(11)
    n = (1 << 20) + 3
    k = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)).to(cuda)
    v = torch.arange(n, dtype=torch.int32, device=cuda).view(torch.uint32)
    sk, idx = torch.sort(k.view(torch.int32) ^ (-2**31), stable=True)
    ok, ov = trt.sort(k, v, method="radix")
    assert torch.equal(ok.view(torch.int32), sk ^ (-2**31))
    assert torch.equal(ov.view(torch.int32), idx.to(torch.int32))
    assert torch.equal(trt.sort(k, method="radix"), ok)
    h0 = _build.DIGIT_HISTOGRAM.launches
    assert torch.equal(trt.sort(ok, method="radix", check_order=True), ok)
    assert _build.DIGIT_HISTOGRAM.launches == h0
    small = k.view(torch.int32) & 15
    out, _, n_run = radix.sort_u32(small, check_order=True, return_passes=True)
    assert n_run == 2 and torch.equal(out, torch.sort(small)[0])


def _launches():
    return {k.name: k.launches for k in (_build.BITONIC_TILE, _build.BITONIC_GLOBAL_STAGE,
                                         _build.DIGIT_HISTOGRAM, _build.SCAN, _build.REORDER)}


@pytest.mark.parametrize("n,engine", [(sort_mod.AUTO_RADIX_MIN_N[32], "radix"),
                                      (1 << 10, "bitonic"),
                                      (sort_mod.AUTO_RADIX_MIN_N[32] - 1, "bitonic")])
def test_auto_launches_the_engine_of_its_size(cuda, n, engine):
    """'auto' on u32 key + rank: from the threshold on K5, K4 and K6, 16
    each, and no K1; below it K1 alone. Both give torch.sort's bytes."""
    k = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32, device=cuda)
    v = torch.arange(n, dtype=torch.int32, device=cuda).view(torch.uint32)
    before = _launches()
    ok, ov = trt.sort(k.view(torch.uint32), v, values_are_ranks=True)
    d = {name: c - before[name] for name, c in _launches().items()}
    sk, idx = torch.sort(k ^ (-2**31), stable=True)
    assert torch.equal(ok.view(torch.int32), sk ^ (-2**31))
    assert torch.equal(ov.view(torch.int32), idx.to(torch.int32))
    if engine == "radix":
        assert d == {"bitonic_tile_kernel": 0, "bitonic_global_stage_kernel": 0,
                     "digit_histogram_kernel": 16, "scan_kernel": 16, "reorder_kernel": 16}
    else:
        assert d["bitonic_tile_kernel"] >= 1 and d["digit_histogram_kernel"] == 0
        assert d["scan_kernel"] == 0 and d["reorder_kernel"] == 0


@pytest.mark.parametrize("kind", ["sorted", "reversed", "random", "equal hi", "boundary", "short"])
def test_disorder_cols_kernel_matches_plain(cuda, kind):
    """K3 on the (hi, lo) view of u64 keys. 'boundary': one inversion whose
    pair (255, 256) straddles the first two 256-thread CUDA blocks."""
    rng = np.random.default_rng(8)
    n = 3 if kind == "short" else (1 << 20) + 3
    u = rng.integers(0, 2**64, n, dtype=np.uint64)
    if kind == "equal hi":
        u = (u & np.uint64(0xFFFFFFFF)) | (np.uint64(77) << np.uint64(32))
    if kind in ("sorted", "boundary"):
        u.sort()
    elif kind == "reversed":
        u = np.sort(u)[::-1].copy()
    if kind == "boundary":
        u[256] = u[255] - np.uint64(1)  # same hi word, smaller lo word
        assert u[256] >> np.uint64(32) == u[255] >> np.uint64(32)
    hi = torch.from_numpy((u >> np.uint64(32)).astype(np.uint32).view(np.int32)).to(cuda)
    lo = torch.from_numpy(u.astype(np.uint32).view(np.int32)).to(cuda)
    before = _build.DISORDER_COLS.launches
    got = checksort.disorder_cols_kernel(hi, lo)
    assert _build.DISORDER_COLS.launches == before + 1
    assert torch.equal(got, checksort.disorder_cols_plain(hi, lo))
    assert int(got) == int(np.count_nonzero(u[:-1] > u[1:]))


@pytest.mark.parametrize("method", ["auto", "bitonic", "radix"])
def test_sort64_on_card_matches_torch_sort(cuda, method):
    """u64 key + iota (the 3-column (hi, lo, rank) network) and the 7-column
    / 6-column bit_count=40 path with u64 values, against torch.sort and
    golden; the 64-bit gate runs K3."""
    rng = np.random.default_rng(12)
    n = (1 << 18) + 3
    k = rng.integers(0, 2**64, n, dtype=np.uint64)
    k[: n // 2] = (k[: n // 2] & np.uint64(0xFFFF)) | (np.uint64(5) << np.uint64(32))
    kt = torch.from_numpy(k).to(cuda)
    iota = torch.arange(n, dtype=torch.int32, device=cuda).view(torch.uint32)
    ref, idx = torch.sort(kt.view(torch.int64) ^ (-2**63), stable=True)
    ok, ov = trt.sort(kt, iota, method=method, values_are_ranks=True)
    assert torch.equal(ok.view(torch.int64), ref ^ (-2**63))
    assert torch.equal(ov.view(torch.int32), idx.to(torch.int32))
    v = rng.integers(0, 2**64, n, dtype=np.uint64)
    ok, ov = trt.sort(kt, torch.from_numpy(v).to(cuda), method=method, bit_count=40)
    gk, gv = golden_sort(k, v, bit_count=40)
    assert np.array_equal(ok.cpu().numpy(), gk) and np.array_equal(ov.cpu().numpy(), gv)
    srt = torch.from_numpy(np.sort(k)).to(cuda)
    c0, h0 = _build.DISORDER_COLS.launches, _build.DIGIT_HISTOGRAM.launches
    assert torch.equal(trt.sort(srt, method=method, check_order=True), srt)
    assert _build.DISORDER_COLS.launches == c0 + 2 and _build.DIGIT_HISTOGRAM.launches == h0
    assert trt.is_sorted(srt) and not trt.is_sorted(kt)
    assert int(trt.disorder_count(kt)) == int(np.count_nonzero(k[:-1] > k[1:]))


@pytest.mark.parametrize("rows,row_len,n_arr,n_keys,tile", [
    (3, 128, 2, 2, None), (1000, 128, 1, 1, None), (5, 1024, 3, 2, None),
    (3, 4096, 2, 2, 1024), (3, 2048, 8, 4, 256), (2, 8192, 5, 4, None),
    # the batched sorts' rows of 16,384: keys-only at tile 2^15 (two rows
    # a chunk) and key + rank
    (8, 16384, 1, 1, None), (8, 16384, 2, 2, None),
])
def test_row_schedule_matches_plain(cuda, rows, row_len, n_arr, n_keys, tile):
    """The row-local network, call by call, against the plain version on a
    length padded to whole chunks (no power of two for 3, 5 or 1,000
    rows); rows longer than the tile run global calls and the final round
    from stride row_len/2."""
    t, padded = bitonic.rows_layout(rows, row_len, n_arr, tile)
    n = padded * row_len
    x = _columns(np.random.default_rng(rows + row_len), n_arr, n_keys, n).to(cuda)
    calls = bitonic.row_schedule(row_len, t)
    assert any(c[0] == "global" for c in calls) == (row_len > t)
    for call in calls:
        got = bitonic.run_schedule(x.clone(), [call], n_keys=n_keys, tile=t)
        stages = call[1] if call[0] == "tile" else [call[1:]]
        want = bitonic.stages_plain(x.clone(), stages, n_keys)
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
        x = got
    keys = x[:n_keys].cpu().numpy().view(np.uint32)
    assert np.array_equal(np.lexsort([*keys[::-1], np.arange(n) // row_len]), np.arange(n))


def test_batched_and_segmented_on_card_match_golden(cuda):
    """Both entry points on the card: K1 (and K4 for the segment ids) run,
    and every row or segment equals the golden sort."""
    rng = np.random.default_rng(13)
    B, n = 37, 3000
    k = rng.integers(0, 2**32, (B, n), dtype=np.uint64).astype(np.uint32)
    k[3] %= 7
    v = rng.integers(0, 2**32, (B, n), dtype=np.uint64).astype(np.uint32)
    t0 = _build.BITONIC_TILE.launches
    for kw in ({}, {"bit_count": 12, "descending": True}, {"tile": 512}):
        ok, ov = trt.sort_batched(k, v, **kw)
        gkw = {a: b for a, b in kw.items() if a != "tile"}
        for b in range(B):
            gk, gv = golden_sort(k[b], v[b], **gkw)
            assert np.array_equal(ok[b].cpu().numpy(), gk), (kw, b)
            assert np.array_equal(ov[b].cpu().numpy(), gv), (kw, b)
    assert _build.BITONIC_TILE.launches > t0
    assert np.array_equal(trt.argsort_batched(k).cpu().numpy(),
                          np.argsort(k, axis=1, kind="stable"))
    flat = k.reshape(-1)
    offs = np.concatenate([[0, 0], np.sort(rng.choice(flat.size, 40, replace=False)),
                           [flat.size, flat.size]])
    s0 = _build.SCAN.launches
    for kw in ({}, {"bit_count": 16}, {"method": "xla"}):
        got = trt.sort_segments(flat, offs, **kw).cpu().numpy()
        want = flat.copy()
        for a, b in zip(offs[:-1], offs[1:]):
            if b > a:
                want[a:b] = golden_sort(flat[a:b], **{x: y for x, y in kw.items() if x != "method"})
        assert np.array_equal(got, want), kw
    assert _build.SCAN.launches > s0
    ranks = trt.argsort_segments(flat, offs).cpu().numpy()
    for a, b in zip(offs[:-1], offs[1:]):
        assert np.array_equal(ranks[a:b], np.argsort(flat[a:b], kind="stable")), (a, b)
    k64 = rng.integers(0, 2**64, flat.size, dtype=np.uint64)
    v64 = rng.integers(0, 2**64, flat.size, dtype=np.uint64)
    ok, ov = trt.sort_segments(k64, offs, v64, bit_count=40)
    for a, b in zip(offs[:-1], offs[1:]):
        if b > a:
            gk, gv = golden_sort(k64[a:b], v64[a:b], bit_count=40)
            assert np.array_equal(ok[a:b].cpu().numpy(), gk)
            assert np.array_equal(ov[a:b].cpu().numpy(), gv)


@pytest.mark.parametrize("variant,n_arr,stable", sorted(explore_ce.VARIANTS))
def test_explore_ce_kernel_matches_plain(cuda, variant, n_arr, stable):
    """P1 on one tile (fewer problems than SMs) and on two, both
    formulations, 16 and 0 stages, on the probe's input and on a tie-heavy
    one; into a new tensor and in place."""
    rng = np.random.default_rng(n_arr)
    before = _build.EXPLORE_CE.launches
    for n in (explore_ce.T, 2 * explore_ce.T):
        x = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
                             .view(np.int32)).to(cuda)
        for cols in (explore_ce.probe_columns(x, n_arr, variant),
                     explore_ce.tie_columns(n, n_arr, variant, 3, cuda)):
            want = explore_ce.ce_plain(cols, variant, stable)
            for form in explore_ce.FORMULATIONS:
                got = explore_ce.ce_stages(cols, variant, stable, formulation=form)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (n, form)
                assert torch.equal(explore_ce.ce_stages(cols, variant, stable, formulation=form,
                                                        n_stages=0), cols), (n, form)
                y = cols.clone()
                explore_ce.ce_stages_into(y, y, variant, stable, formulation=form)
                assert torch.equal(y, want), (n, form, "in place")
    assert _build.EXPLORE_CE.launches == before + 24


@pytest.mark.parametrize("variant,n_arr,stable", sorted(explore_ce.VARIANTS))
def test_explore_ce_launch_grid(cuda, variant, n_arr, stable):
    """The grid the C launch computes: one block a problem where there are
    fewer problems than resident blocks (16 on one tile, 32 on two), every
    resident block at 2^24 (2,048 problems); and lengths it refuses."""
    for form in explore_ce.FORMULATIONS:
        r = explore_ce.ce_resident(variant, n_arr, stable, form)
        assert r["blocks_per_sm"] >= 1 and r["sms"] == torch.cuda.get_device_properties(
            cuda).multi_processor_count
        assert r["grid"] == min(2048, r["blocks_per_sm"] * r["sms"])
        assert explore_ce.ce_resident(variant, n_arr, stable, form, explore_ce.T)["grid"] == 16
        assert explore_ce.ce_resident(variant, n_arr, stable, form, 2 * explore_ce.T)["grid"] == 32
        for n in (0, explore_ce.T + explore_ce.PROBLEM):
            with pytest.raises(RuntimeError):
                explore_ce.ce_resident(variant, n_arr, stable, form, n)


@pytest.mark.parametrize("tiles", [1, 3, 33])
def test_explore_blocksort_kernels_match_plain(cuda, tiles):
    """P2 in each cluster size the card holds; P3 with every split of its
    rings, the register kernel (split 1) and the split kernel counted
    apart."""
    eb = explore_blocksort
    x = eb.random_tiles(tiles, tiles, cuda)
    clusters = [c for c in eb.CE_CLUSTERS if eb.ce_active(c, cuda) >= 1]
    assert 8 in clusters and eb.ce_cluster(1, cuda) == clusters[-1]
    kernels = (_build.BLOCKSORT_CE, _build.BLOCKSORT_STAGES, _build.BLOCKSORT_STAGES_SPLIT)
    before = [k.launches for k in kernels]
    for cluster in clusters:
        assert torch.equal(eb.ce_tiles(x, cluster), eb.ce_plain(x)), cluster
    for n_stages in (0, 1, 7, eb.NSTAGE):
        for split in eb.RING_SPLITS:
            assert torch.equal(eb.stage_tiles(x, n_stages, split),
                               eb.stages_plain(x, n_stages)), (n_stages, split)
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        len(clusters), 4, 4 * (len(eb.RING_SPLITS) - 1)]
    assert eb.launch_floor_ms(cuda) > 0


@pytest.mark.parametrize("dtype", explore_keys16.DTYPES, ids=str)
def test_explore_keys16_kernel_matches_plain(cuda, dtype):
    """P9 on 1,000 rows (a partial last block), NaN, -0.0 and subnormals in
    the first 64, at reps 0 to 5, 16 and 256."""
    x = explore_keys16.random_rows(dtype, 1000, 11, cuda)
    view = torch.int32 if dtype == torch.int32 else torch.int16
    before = _build.KEYS16_STAGE.launches
    reps_list = (0, 1, 2, 3, 4, 5, 16, 256)
    for reps in reps_list:
        got = explore_keys16.stage_kernel(x, reps)
        assert got.dtype == dtype
        assert torch.equal(got.view(view), explore_keys16.stage_plain(x, reps).view(view)), reps
    assert _build.KEYS16_STAGE.launches == before + len(reps_list)


_TILE_ROWS = explore_scan.CHAIN_TILE // explore_scan.LANES


@pytest.mark.parametrize("block_rows,blocks", [(1, 1), (8, 1), (8, 37), (24, 37), (512, 256)]
                         + [(_TILE_ROWS, t) for t in explore_scan.CHAIN_EDGE_TILES])
def test_explore_scan_kernels_match_plain(cuda, block_rows, blocks):
    """P4-P7 on one block; on 8 x 37 and 24 x 37 rows, whose last chunk of
    P4 and last tile of P5 and P7 are partial; on 2^24, where 64 clusters
    of 8 tiles chain; and on 1, 7, 8, 9, 15, 16, 17, 512 and 513 whole
    tiles (within and across the chain's clusters, a last cluster with
    surplus blocks); full-range u32, so that every sum wraps."""
    es = explore_scan
    x = es.random_rows(block_rows * blocks, blocks, cuda)
    offs = es.block_offsets(es.blocksum_plain(x, block_rows))
    kernels = (_build.BLOCKSUM, _build.ADDBACK, _build.GRID_COPY, _build.CHAINED_SCAN)
    before = [k.launches for k in kernels]
    assert torch.equal(es.blocksum_kernel(x, block_rows), es.blocksum_plain(x, block_rows))
    assert torch.equal(es.addback_kernel(offs, x, block_rows),
                       es.addback_plain(offs, x, block_rows))
    want = es.streaming_scan_plain(x, block_rows)
    assert torch.equal(es.twopass_scan(x, block_rows), want)
    assert torch.equal(es.grid_copy(x, block_rows), x)
    assert torch.equal(es.streaming_scan(x, block_rows), want)
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 1, 1]


@pytest.mark.parametrize("tiles", explore_scan.CHAIN_EDGE_TILES)
def test_chained_scan_edges_repeated(cuda, tiles):
    """P7 at the chain's edges (`explore_scan.chain_edge_inputs`: whole
    tiles; a partial last tile with n % 4 = 3; a view one element in, the
    scalar path), full-range u32, each launched 50 times on one stream and
    compared every time, so that a race in the chain or the cluster's
    hand-off shows."""
    es = explore_scan
    for label, x in es.chain_edge_inputs(tiles, es.full_range_u32, cuda):
        before = _build.CHAINED_SCAN.launches
        es.check_repeated(lambda a: es.launch_chained(_build.CHAINED_SCAN, a), x,
                          scan.scan_plain(x), f"P7 at {tiles} tiles ({label})")
        assert _build.CHAINED_SCAN.launches == before + es.REPEATS


def test_grid_copy_edges_repeated(cuda):
    """P6 on one vector, one chunk and a vector, a share of one chunk and a
    vector for every SM, a chunk count that is no multiple of the SM count,
    and 2^24 + 4; each launched 50 times and compared every time."""
    es = explore_scan
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n in es.copy_edge_sizes(sms):
        x = torch.from_numpy(es.full_range_u32(n, n).view(np.int32)).to(cuda)
        before = _build.GRID_COPY.launches
        es.check_repeated(es.copy_flat, x, x, f"P6 at n = {n}")
        assert _build.GRID_COPY.launches == before + es.REPEATS


def test_chained_scan_runs_in_resident_clusters(cuda):
    cluster, active = explore_scan.chain_clusters()
    assert cluster == explore_scan.CHAIN_CLUSTER
    assert active >= 1


@pytest.mark.parametrize("n", [1, 5000, explore_keys16.CHAIN_TILE,
                               explore_keys16.CHAIN_TILE + 1, 1 << 24]
                         + [t * explore_keys16.CHAIN_TILE for t in explore_scan.CHAIN_EDGE_TILES
                            if t not in (1, 512)])
def test_cummax_kernel_matches_plain(cuda, n):
    """P8 on full-range int32, a rising walk from below zero, all-negative
    input and a counting sort's run starts; one tile, a partial last tile,
    7 to 17 tiles (within and across the clusters of 8), 64 chained
    clusters and 513 tiles."""
    inputs = explore_keys16.cummax_inputs(n, n, cuda)
    before = _build.CUMMAX.launches
    for x in inputs:
        assert torch.equal(explore_keys16.cummax_1d(x), explore_keys16.cummax_plain(x))
    assert _build.CUMMAX.launches == before + len(inputs)


@pytest.mark.parametrize("tiles", explore_scan.CHAIN_EDGE_TILES)
def test_cummax_edges_repeated(cuda, tiles):
    """P8 at the chain's edges, as P7 above, on a rising walk (each tile's
    max starts from its carry), each launched 50 times."""
    for label, x in explore_scan.chain_edge_inputs(tiles, explore_keys16.rising_walk, cuda):
        explore_scan.check_repeated(explore_keys16.cummax_1d, x,
                                    explore_keys16.cummax_plain(x),
                                    f"P8 at {tiles} tiles ({label})")


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_counting_sorts_on_card_match_torch_sort(cuda, dist):
    rng = np.random.default_rng(5)
    n = 1 << 20
    k = (rng.integers(0, 2**16, n) if dist == "uniform"
         else np.minimum(rng.zipf(1.3, n), 2**16 - 1)).astype(np.uint16)
    kt = torch.from_numpy(k.view(np.int16)).to(cuda).view(torch.uint16)
    want = torch.from_numpy(np.sort(k).view(np.int16)).to(cuda)
    for sort in (explore_keys16.counting_sort_u16, explore_keys16.counting_sort_u16_matmul):
        got = sort(kt)
        assert got.dtype == torch.uint16
        assert torch.equal(got.view(torch.int16), want)
