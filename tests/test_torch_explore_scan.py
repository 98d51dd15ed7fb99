"""Probes P4-P7 on the port (`tpu_radix_sort_torch/benchmarks/explore_scan.py`,
its kernels through the plain versions on the CPU) against the probe's own
JAX bodies, `benchmarks/explore_scan.py`, run by `pl.pallas_call` in
interpret mode: `_blocksum_kernel` (its sums in SMEM), `twopass_scan`,
`_copy_kernel` and `_scan_kernel_and` (its carry in SMEM scratch), over 4
blocks of 8 and of 16 rows, and against numpy; byte for byte (tolerance 0:
u32 sums and scans are exact, wrapping mod 2^32).

Inputs: full-range u32 patterns, so that the sums wrap, and the probe's
values 0..7."""
import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu_radix_sort_torch.benchmarks import explore_scan as es

_SPEC = importlib.util.spec_from_file_location(
    "explore_scan_probe", Path(__file__).resolve().parents[1] / "benchmarks" / "explore_scan.py")
probe = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(probe)

BLOCKS = 4
LANES = es.LANES


def _inputs(block_rows, kind):
    rng = np.random.default_rng(block_rows)
    shape = (BLOCKS * block_rows, LANES)
    hi = 2**32 if kind == "full" else 8
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _port(x_np):
    return torch.from_numpy(x_np.view(np.int32))


def _bits(t):
    return t.numpy().view(np.uint32)


def _grid_call(kernel, x_np, block_rows, **kw):
    spec = pl.BlockSpec((block_rows, LANES), lambda i: (i, 0))
    return np.asarray(pl.pallas_call(
        kernel, grid=(x_np.shape[0] // block_rows,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x_np.shape, jnp.uint32), interpret=True, **kw,
    )(jnp.asarray(x_np)))


def _exclusive(x_np):
    flat = x_np.reshape(-1)
    return (np.cumsum(flat, dtype=np.uint32) - flat).reshape(x_np.shape)


CASES = [(br, kind) for br in (8, 16) for kind in ("full", "probe")]


@pytest.mark.parametrize("block_rows,kind", CASES)
def test_blocksum_matches_the_probe_body(block_rows, kind):
    x_np = _inputs(block_rows, kind)
    want = np.asarray(pl.pallas_call(
        functools.partial(probe._blocksum_kernel, rows=block_rows), grid=(BLOCKS,),
        in_specs=[pl.BlockSpec((block_rows, LANES), lambda b: (b, 0))],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((BLOCKS,), jnp.uint32), interpret=True,
    )(jnp.asarray(x_np)))
    got = es.blocksum_kernel(_port(x_np), block_rows)  # a CPU tensor: the plain version
    assert got.dtype == torch.int32 and got.shape == (BLOCKS,)
    assert np.array_equal(_bits(got), want)
    assert np.array_equal(want, x_np.reshape(BLOCKS, -1).sum(1, dtype=np.uint32))


@pytest.mark.parametrize("block_rows,kind", CASES)
def test_twopass_and_addback_match_the_probe(block_rows, kind):
    """The probe's `twopass_scan` (P4, shifted cumsum, P5); and P5 alone
    with arbitrary full-range offsets against numpy."""
    x_np = _inputs(block_rows, kind)
    want = np.asarray(probe.twopass_scan(jnp.asarray(x_np), block_rows, interpret=True))
    x = _port(x_np)
    assert np.array_equal(_bits(es.twopass_scan(x, block_rows)), want)
    assert np.array_equal(want, _exclusive(x_np))
    offs_np = np.random.default_rng(7).integers(0, 2**32, BLOCKS, dtype=np.uint64).astype(
        np.uint32)
    got = es.addback_kernel(_port(offs_np), x, block_rows)
    blocks = x_np.reshape(BLOCKS, -1)
    local = np.cumsum(blocks, axis=1, dtype=np.uint32) - blocks + offs_np[:, None]
    assert np.array_equal(_bits(got), local.reshape(x_np.shape))


@pytest.mark.parametrize("block_rows,kind", CASES)
def test_copy_and_streaming_scan_match_the_probe_bodies(block_rows, kind):
    x_np = _inputs(block_rows, kind)
    x = _port(x_np)
    want_copy = _grid_call(probe._copy_kernel, x_np, block_rows)
    assert np.array_equal(_bits(es.grid_copy(x, block_rows)), want_copy)
    want_scan = _grid_call(probe._scan_kernel_and, x_np, block_rows,
                           scratch_shapes=[pltpu.SMEM((1,), jnp.uint32)])
    assert np.array_equal(_bits(es.streaming_scan(x, block_rows)), want_scan)
    assert np.array_equal(want_scan, _exclusive(x_np))


def test_plain_versions_on_one_block_and_many():
    """One block of one row, and 37 blocks of 24 rows, against numpy."""
    for br, nb in ((1, 1), (24, 37)):
        x_np = np.random.default_rng(nb).integers(0, 2**32, (br * nb, LANES),
                                                  dtype=np.uint64).astype(np.uint32)
        x = _port(x_np)
        sums = x_np.reshape(nb, -1).sum(1, dtype=np.uint32)
        assert np.array_equal(_bits(es.blocksum_plain(x, br)), sums)
        assert np.array_equal(_bits(es.block_offsets(_port(sums))),
                              np.cumsum(sums, dtype=np.uint32) - sums)
        for f in (es.twopass_plain, es.streaming_scan_plain):
            assert np.array_equal(_bits(f(x, br)), _exclusive(x_np))
        assert np.array_equal(_bits(es.grid_copy_plain(x, br)), x_np)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    good = torch.zeros((16, LANES), dtype=torch.int32)
    wrappers = (es.blocksum_kernel, es.grid_copy, es.streaming_scan, es.twopass_scan)
    for f in wrappers:
        with pytest.raises(TypeError):
            f(good.to(torch.int64), 8)
        with pytest.raises(ValueError):
            f(torch.zeros((16, 64), dtype=torch.int32), 8)
        with pytest.raises(ValueError):
            f(good, 3)  # 16 rows are not whole blocks of 3
        with pytest.raises(ValueError):
            f(good, 0)
    offs = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        es.addback_kernel(offs, good, 4)  # 4 blocks, 2 offsets
    with pytest.raises(TypeError):
        es.addback_kernel(offs.to(torch.int64), good, 8)
    with pytest.raises(ValueError):
        es.addback_kernel(offs, good, 5)
    with pytest.raises(ValueError):
        es.chain_layout(0)


# ---- the chained scan's layout on the card (no kernel runs) -----------------
T = es.CHAIN_TILE  # 32,768


@pytest.mark.parametrize("n,layout", [
    (1, (1, 1, 8, 2)), (4, (1, 1, 8, 2)), (T - 1, (1, 1, 8, 2)), (T, (1, 1, 8, 2)),
    (T + 1, (2, 1, 8, 2)), (8 * T, (8, 1, 8, 2)), (8 * T + 1, (9, 2, 16, 3)),
    (9 * T, (9, 2, 16, 3)), (1 << 24, (512, 64, 512, 65)), ((1 << 24) + 3, (513, 65, 520, 66)),
])
def test_chain_layout(n, layout):
    """(tiles, clusters, grid blocks, scratch words), by hand: the grid is
    whole clusters of 8, the scratch a flag a cluster and the ticket."""
    assert es.chain_layout(n) == layout
    tiles, clusters, blocks, words = layout
    assert blocks % es.CHAIN_CLUSTER == 0 and blocks >= tiles > blocks - es.CHAIN_CLUSTER
    assert words == clusters + 1


def _cuda_constants():
    """The `constexpr unsigned` constants of csrc/explore_scan.cu, evaluated
    in order (C's integer arithmetic on the names defined before)."""
    src = (Path(es.__file__).resolve().parents[1] / "csrc" / "explore_scan.cu").read_text()
    env = {}
    for name, expr in re.findall(r"constexpr unsigned (\w+) = ([^;]+);", src):
        expr = re.sub(r"\b(0x[0-9a-fA-F]+|\d+)u\b", r"\1", expr).replace("/", "//")
        env[name] = eval(expr, {"__builtins__": {}}, dict(env))
    return env


def test_python_and_cuda_constants_agree():
    c = _cuda_constants()
    assert c["kTile"] == es.CHAIN_TILE
    assert c["kCluster"] == es.CHAIN_CLUSTER
    assert c["kCopyChunkBytes"] == 4 * es.COPY_CHUNK
