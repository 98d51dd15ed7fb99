"""Probes P2 and P3 on the port (`tpu_radix_sort_torch/benchmarks/
explore_blocksort.py`, their kernels through the plain versions on the CPU)
against the probe's own JAX bodies, `ce_kernel` and `stages_kernel` of
`benchmarks/explore_blocksort.py`, run by `pl.pallas_call` in interpret
mode on one 512 x 128 u32 tile, byte for byte (tolerance 0, integer work).

That script runs its benchmarks when imported, so the two bodies and the
constants `ROWS`, `LANES` and `NSTAGE` are taken from its source with
`ast` and run here on their own.

The card's schedules are modelled here in torch and held against the same
bodies: P2 band by band, a band a block of a cluster of C blocks, each
thread's chunk summed down its lane and the bands' totals carried to the
later blocks; P3 with each ring split across s lanes of a warp, each
lane's last slot handed to the next lane every stage. The host's choice of
s (`ring_split`) and the constants the kernels share with the module
(read from `csrc/explore_blocksort.cu`) are checked too."""
import ast
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu_radix_sort_torch.benchmarks import explore_blocksort as eb

_ROOT = Path(__file__).resolve().parents[1]
_SOURCE = _ROOT / "benchmarks" / "explore_blocksort.py"
_CUDA = _ROOT / "tpu_radix_sort_torch" / "csrc" / "explore_blocksort.cu"


def _probe_namespace():
    """The probe's kernel bodies and tile constants, and nothing it runs."""
    tree = ast.parse(_SOURCE.read_text())
    keep = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in ("ce_kernel", "stages_kernel"):
            keep.append(node)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, (ast.Name, ast.Tuple)) and {n.id for n in ast.walk(t)
                                                          if isinstance(n, ast.Name)}
                & {"ROWS", "LANES", "NSTAGE"} for t in node.targets):
            keep.append(node)
    ns = {"jax": jax, "jnp": jnp, "pltpu": pltpu}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(_SOURCE), "exec"), ns)
    return ns


probe = _probe_namespace()


def _run(kernel, x):
    f = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.uint32),
                       interpret=True)
    return np.asarray(f(jnp.asarray(x)))


def _tile(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (probe["ROWS"], probe["LANES"]),
                        dtype=np.uint64).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _probe_case(body, seed, kind):
    """A seeded tile of `kind` and the probe body's result on it, cached:
    each body runs once a tile in interpret mode, for the plain version and
    for the card's schedules alike. Neither may write to the tile."""
    x = _tile(seed)
    if kind == "sums wrap":
        x |= np.uint32(0xF0000000)
    elif kind == "ties":
        x &= np.uint32(3)
    elif kind == "top bit":
        x |= np.uint32(0x80000000)
    elif kind == "wraps":  # adding 1 wraps past 0xFFFFFFFF within 64 stages
        x |= np.uint32(0xFFFFFFE0)
    return x, _run(probe[body], x)


def test_constants_match_the_probe():
    assert (probe["ROWS"], probe["LANES"], probe["NSTAGE"]) == (eb.ROWS, eb.LANES, eb.NSTAGE)


@pytest.mark.parametrize("kind", ["random", "sums wrap", "ties"])
def test_p2_plain_matches_the_probe_body(kind):
    x, want = _probe_case("ce_kernel", 1, kind)
    got = eb.ce_tiles(torch.from_numpy(x.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # B tiles: the function of each tile
    both = torch.from_numpy(np.stack([x, _tile(2)]).view(np.int32))
    assert torch.equal(eb.ce_tiles(both)[0], got)


@pytest.mark.parametrize("kind", ["random", "top bit", "wraps"])
def test_p3_plain_matches_the_probe_body(kind):
    x, want = _probe_case("stages_kernel", 3, kind)
    t = torch.from_numpy(x.view(np.int32))
    assert np.array_equal(eb.stage_tiles(t).numpy().view(np.uint32), want)
    assert torch.equal(eb.stage_tiles(t, 0), t)
    three = torch.from_numpy(np.stack([_tile(4), x, _tile(5)]).view(np.int32))
    assert torch.equal(eb.stage_tiles(three)[1], eb.stage_tiles(t))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        eb.ce_tiles(torch.zeros((256, 128), dtype=torch.int32))
    with pytest.raises(TypeError):
        eb.stage_tiles(torch.zeros((512, 128), dtype=torch.int64))
    with pytest.raises(ValueError):
        eb.stage_tiles(torch.zeros((512, 128), dtype=torch.int32), -1)


def test_stage_bound():
    """P3's bound: a minimum or maximum an element a stage at the card's
    integer rate, above the bytes at 64 stages; the bytes at 0 stages."""
    t, by = eb.stage_bound_ms(eb.RATE_TILES)
    assert by == "operations"
    assert t == pytest.approx(eb.RATE_TILES * eb.ROWS * eb.LANES * eb.NSTAGE
                              / (132 * 64 * 1.98e9) * 1e3)
    t, by = eb.stage_bound_ms(eb.RATE_TILES, 0)
    assert by == "bytes" and t == pytest.approx(2**27 / 3.35e12 * 1e3)


# ---- the card's schedules, modelled -------------------------------------------
_M = 2**32


def _ce_bands(x, cluster, chunks=eb.CE_CHUNKS):
    """P2 on one u32 tile as a cluster of `cluster` blocks computes it:
    block b copies its band of 512 / cluster rows and the 8 rows above it
    (band 0: rows 504-511), takes the minimum or maximum of each row and
    the row 8 above it in the lane to its left, sums each of `chunks`
    chunks down each lane, and adds the earlier chunks' totals and then
    the earlier blocks' band totals (the carries it reads after the
    cluster barrier)."""
    t = torch.from_numpy(x.astype(np.int64))
    band = eb.ROWS // cluster
    per = band // chunks
    src = (torch.arange(eb.LANES) - 1) % eb.LANES  # the lane roll by one
    sums, totals = [], []
    for b in range(cluster):
        rows = t[[(b * band - eb.SHIFT + i) % eb.ROWS for i in range(band + eb.SHIFT)]][:, src]
        a, p = rows[eb.SHIFT:], rows[:-eb.SHIFT]
        r = b * band + torch.arange(band)
        z = torch.where(((r // eb.SHIFT) % 2 == 1)[:, None], torch.maximum(a, p),
                        torch.minimum(a, p))
        run = torch.cumsum(z.view(chunks, per, eb.LANES), dim=1) % _M  # a thread's registers
        chunk_totals = run[:, -1]
        before = (torch.cumsum(chunk_totals, dim=0) - chunk_totals) % _M
        sums.append(((run + before[:, None]) % _M).view(band, eb.LANES))
        totals.append(chunk_totals.sum(dim=0) % _M)
    out = [(v + sum(totals[:b], torch.zeros(eb.LANES, dtype=torch.int64))) % _M
           for b, v in enumerate(sums)]
    return torch.cat(out).numpy().astype(np.uint32)


def _stages_split(x, split, n_stages):
    """P3 on one u32 tile with each of its 1,024 rings (lane l, residue
    c = r mod 8; slot j is row c + 8j) split across `split` lanes of 64 /
    split slots: a stage hands each lane the last slot of the ring's
    previous lane from before the stage (lane 0 that of lane split - 1,
    the ring's wrap), the shuffle, and a slot's parity is its register's."""
    t = torch.from_numpy(x.astype(np.int64))
    m = eb.ROWS // eb.SHIFT // split
    parts = t.view(-1, eb.SHIFT, eb.LANES).permute(1, 2, 0).reshape(eb.SHIFT, eb.LANES, split, m)
    even = torch.arange(m) % 2 == 0
    for _ in range(n_stages):
        handed = torch.roll(parts[..., -1], 1, dims=2)
        partner = torch.cat([handed[..., None], parts[..., :-1]], dim=3)
        parts = (torch.where(even, torch.minimum(parts, partner), torch.maximum(parts, partner))
                 + 1) % _M
    return parts.reshape(eb.SHIFT, eb.LANES, -1).permute(2, 0, 1).reshape(
        eb.ROWS, eb.LANES).numpy().astype(np.uint32)




@pytest.mark.parametrize("kind", ["random", "sums wrap", "ties"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_p2_cluster_schedule_matches_the_probe_body(cluster, kind):
    x, want = _probe_case("ce_kernel", 1, kind)
    assert np.array_equal(_ce_bands(x, cluster), want)


@pytest.mark.parametrize("kind", ["random", "top bit", "wraps"])
@pytest.mark.parametrize("split", eb.RING_SPLITS)
def test_p3_split_schedule_matches_the_probe_body(split, kind):
    x, want = _probe_case("stages_kernel", 3, kind)
    assert np.array_equal(_stages_split(x, split, eb.NSTAGE), want)
    for n_stages in (0, 1, eb.NSTAGE - 1):
        assert np.array_equal(_stages_split(x, split, n_stages),
                              _plain_stages(kind, n_stages)), n_stages


@functools.lru_cache(maxsize=None)
def _plain_stages(kind, n_stages):
    """P3's plain version on the tile of `kind` at `n_stages` stages (cached
    across the splits)."""
    x, _ = _probe_case("stages_kernel", 3, kind)
    return eb.stages_plain(torch.from_numpy(x.view(np.int32)), n_stages).numpy().view(np.uint32)


@pytest.mark.parametrize("sms", [1, 8, 66, 114, 132, 144, 1000])
def test_ring_split_is_the_least_split_that_covers_the_sms(sms):
    for tiles in range(1, 300):
        s = eb.ring_split(tiles, sms)
        assert s in eb.RING_SPLITS and s & (s - 1) == 0 and 64 % s == 0
        assert eb.stage_grid(tiles, s) >= sms or s == eb.RING_SPLITS[-1]
        assert s == 1 or eb.stage_grid(tiles, s // 2) < sms
        assert eb.stage_grid(tiles, s) == 4 * s * tiles


def test_ring_split_on_the_h100():
    """132 SMs: a ring a thread at 256 tiles and from 33; one tile across
    32 lanes (128 blocks); the card's check tiles run splits 32, 32, 16, 1, 1."""
    assert eb.ring_split(eb.RATE_TILES, 132) == 1
    assert [eb.ring_split(t, 132) for t in eb.STAGE_CHECK_TILES] == [32, 32, 16, 1, 1]
    assert [eb.ring_split(t, 132) for t in (4, 5, 9, 17, 32, 33)] == [16, 8, 4, 2, 2, 1]
    for bad in ((0, 132), (1, 0)):
        with pytest.raises(ValueError):
            eb.ring_split(*bad)


def test_choose_cluster():
    """The largest cluster size whose clusters for every tile are resident
    at once, else the smallest; the H100's counts (77 clusters of 8, 49 of
    16) give 16 on one tile and 8 on 256."""
    h100 = {8: 77, 16: 49}
    assert [eb.choose_cluster(t, h100) for t in (1, 49, 50, eb.RATE_TILES)] == [16, 16, 8, 8]
    assert eb.choose_cluster(1, {8: 62, 16: 0}) == 8
    assert eb.choose_cluster(100, {8: 10, 16: 10}) == 8
    assert eb.choose_cluster(100, {8: 0, 16: 10}) == 16
    with pytest.raises(RuntimeError):
        eb.choose_cluster(1, {8: 0, 16: 0})
    with pytest.raises(ValueError):
        eb.choose_cluster(0, h100)


def test_constants_match_the_kernels():
    src = _CUDA.read_text()

    def const(name):
        return int(re.search(rf"constexpr int [^;]*\b{name} = (\d+)", src).group(1))

    assert (const("kRows"), const("kLanes"), const("kShift")) == (eb.ROWS, eb.LANES, eb.SHIFT)
    assert (const("kCeChunks"), const("kStageThreads")) == (eb.CE_CHUNKS, eb.STAGE_THREADS)
    assert re.findall(r"case (\d+): return launch_split<", src) == [
        str(s) for s in eb.RING_SPLITS[1:]]
    assert re.findall(r"blocksort_ce_kernel<(\d+)>, blocks", src) == [
        str(c) for c in eb.CE_CLUSTERS]


def test_new_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((512, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        eb.ce_tiles(x, cluster=4)
    with pytest.raises(ValueError):
        eb.stage_tiles(x, split=3)
    with pytest.raises(ValueError):
        eb.stage_tiles(x, split=64)
    with pytest.raises(ValueError):
        eb.launch_floor_ms("cpu", cluster=4)
    with pytest.raises(ValueError):  # a device time needs the card
        eb.launch_floor_ms("cpu")
    # on the CPU every split and cluster is the plain version
    assert torch.equal(eb.stage_tiles(x, 3, split=32), eb.stages_plain(x, 3))
    assert torch.equal(eb.ce_tiles(x, cluster=16), eb.ce_plain(x))


def test_p2_bound():
    """P2's bound: its bytes, read once and written once, above one minimum
    or maximum an element, on one tile and on 256."""
    for tiles in (1, eb.RATE_TILES):
        t, by = eb.stage_bound_ms(tiles, 1)
        assert by == "bytes" and t == pytest.approx(tiles * 2**19 / 3.35e12 * 1e3)
