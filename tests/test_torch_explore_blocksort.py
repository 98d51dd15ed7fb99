"""Probes P2 and P3 on the port (`tpu_radix_sort_torch/benchmarks/
explore_blocksort.py`, their kernels through the plain versions on the CPU)
against the probe's own JAX bodies, `ce_kernel` and `stages_kernel` of
`benchmarks/explore_blocksort.py`, run by `pl.pallas_call` in interpret
mode on one 512 x 128 u32 tile, byte for byte (tolerance 0, integer work).

That script runs its benchmarks when imported, so the two bodies and the
constants `ROWS`, `LANES` and `NSTAGE` are taken from its source with
`ast` and run here on their own."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpu_radix_sort_torch.benchmarks import explore_blocksort as eb

_SOURCE = Path(__file__).resolve().parents[1] / "benchmarks" / "explore_blocksort.py"


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


def test_constants_match_the_probe():
    assert (probe["ROWS"], probe["LANES"], probe["NSTAGE"]) == (eb.ROWS, eb.LANES, eb.NSTAGE)


@pytest.mark.parametrize("kind", ["random", "sums wrap", "ties"])
def test_p2_plain_matches_the_probe_body(kind):
    x = _tile(1)
    if kind == "sums wrap":
        x |= np.uint32(0xF0000000)
    elif kind == "ties":
        x &= np.uint32(3)
    want = _run(probe["ce_kernel"], x)
    got = eb.ce_tiles(torch.from_numpy(x.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # B tiles: the function of each tile
    both = torch.from_numpy(np.stack([x, _tile(2)]).view(np.int32))
    assert torch.equal(eb.ce_tiles(both)[0], got)


@pytest.mark.parametrize("kind", ["random", "top bit", "wraps"])
def test_p3_plain_matches_the_probe_body(kind):
    x = _tile(3)
    if kind == "top bit":
        x |= np.uint32(0x80000000)
    elif kind == "wraps":  # adding 1 wraps past 0xFFFFFFFF within 64 stages
        x |= np.uint32(0xFFFFFFE0)
    want = _run(probe["stages_kernel"], x)
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
