"""Probe P9 on the port (`tpu_radix_sort_torch/benchmarks/explore_keys16.py`,
its kernel through the plain version on the CPU) against the probe's own
JAX body, `benchmarks/explore_keys16.py` `_stage_kernel`, run by
`pl.pallas_call` in interpret mode over 2 x 2,048 rows (the probe's block)
for int32, uint16, int16 and bfloat16, byte for byte (tolerance 0: the
stages only pick one of two values, or a NaN, which must be the JAX one).

The rows are seeded random patterns; the first 64 hold the values where
lane types disagree: NaNs of both signs and several payloads, subnormals,
-0.0 and +0.0, infinities. 1,024 more rows hold every 16-bit pattern beside
those values. The CUDA kernel's bfloat16 code (a signed minimum and an
unsigned maximum of 32-bit codes) is held against the plain rule through
its torch mirror, on every canonical pattern."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_radix_sort_torch.benchmarks import explore_keys16 as ek

_SPEC = importlib.util.spec_from_file_location(
    "explore_keys16_probe",
    Path(__file__).resolve().parents[1] / "benchmarks" / "explore_keys16.py")
probe = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(probe)

BLOCK = 2048
ROWS = 2 * BLOCK
NUMPY = {torch.int32: np.int32, torch.uint16: np.uint16, torch.int16: np.int16,
         torch.bfloat16: ml_dtypes.bfloat16}


def _jax_stages(x_np, reps):
    block = min(BLOCK, x_np.shape[0])
    f = pl.pallas_call(
        functools.partial(probe._stage_kernel, reps=reps, dtype=x_np.dtype),
        grid=(x_np.shape[0] // block,),
        in_specs=[pl.BlockSpec((block, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((block, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(x_np.shape, x_np.dtype), interpret=True)
    return np.asarray(f(jnp.asarray(x_np)))


@pytest.mark.parametrize("dtype", ek.DTYPES, ids=str)
def test_plain_matches_the_probe_body(dtype):
    x = ek.random_rows(dtype, ROWS, seed=3, device="cpu")
    bits = np.int32 if dtype == torch.int32 else np.int16
    x_np = x.view(torch.int32 if dtype == torch.int32 else torch.int16).numpy()
    x_np = x_np.view(NUMPY[dtype])
    want = _jax_stages(x_np, ek.REPS)
    got = ek.stage_kernel(x, ek.REPS)  # a CPU tensor: the plain version
    assert got.dtype == dtype
    got_bits = got.view(torch.int32 if dtype == torch.int32 else torch.int16).numpy()
    assert np.array_equal(got_bits, want.view(bits))


def test_bf16_nan_and_signed_zero_over_few_stages():
    """One to three stages, where NaN, -0.0 and subnormals have not spread
    or been replaced yet; and 0 stages return the input untouched."""
    x = ek.random_rows(torch.bfloat16, ROWS, seed=5, device="cpu")
    x_np = x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    for reps in (1, 2, 3):
        want = _jax_stages(x_np, reps).view(np.int16)
        assert np.array_equal(ek.stage_plain(x, reps).view(torch.int16).numpy(), want), reps
    assert torch.equal(ek.stage_plain(x, 0).view(torch.int16), x.view(torch.int16))


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("dtype", ek.DTYPES, ids=str)
def test_all_pattern_rows_match_the_probe_body(dtype, reps):
    """Every 16-bit pattern beside a special value (`all_pattern_rows`):
    at reps 1 each meets a special in the maximum and in the minimum."""
    x = ek.all_pattern_rows(dtype, "cpu")
    assert x.shape == (1024, 128)
    bits = torch.int32 if dtype == torch.int32 else torch.int16
    want = _jax_stages(x.view(bits).numpy().view(NUMPY[dtype]), reps)
    got = ek.stage_plain(x, reps).view(bits).numpy()
    assert np.array_equal(got, want.view(got.dtype))


def _canonical_patterns():
    return ek._bf16_canonical(torch.arange(1 << 16, dtype=torch.int32))


def test_bf16_code_round_trips_every_canonical_pattern():
    """The kernel's code (mirrored by `_bf16_code`/`_bf16_decode`): a
    bijection of the canonical patterns onto codes, numbers at 0..0xFFFF
    (the top bit clear) and the two NaNs at 0x80000000 and 0x80000001."""
    c = _canonical_patterns()
    code = ek._bf16_code(c)
    assert torch.equal(ek._bf16_decode(code), c)
    nan = (c & 0x7FFF) > 0x7F80
    assert torch.equal(torch.unique(code[nan]), torch.tensor([-2**31, -2**31 + 1]))
    assert int(code[~nan].min()) >= 0 and int(code[~nan].max()) <= 0xFFFF
    assert torch.unique(code).numel() == torch.unique(c).numel()


def test_bf16_code_min_max_is_the_jax_rule():
    """The signed minimum and the unsigned maximum of two codes are the codes
    of `_bf16_min_max`, for every canonical pattern against each special
    value and 64 seeded random partners (canonicalised)."""
    c = _canonical_patterns()
    rng = np.random.default_rng(11)
    partners = np.concatenate([ek.SPECIALS, rng.integers(0, 2**16, 64).astype(np.uint16)])
    p = ek._bf16_canonical(torch.from_numpy(partners.astype(np.int32)))
    x, y = c[:, None].expand(-1, p.numel()), p[None, :].expand(c.numel(), -1)
    lo, hi = ek._bf16_min_max(x, y)
    cx, cy = ek._bf16_code(x), ek._bf16_code(y)
    ux, uy = cx.to(torch.int64) & 0xFFFFFFFF, cy.to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(ek._bf16_decode(torch.minimum(cx, cy)), lo)
    assert torch.equal(ek._bf16_decode(torch.maximum(ux, uy).to(torch.int32)), hi)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        ek.stage_kernel(torch.zeros((4, 128), dtype=torch.float32))
    with pytest.raises(ValueError):
        ek.stage_kernel(torch.zeros((4, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        ek.stage_kernel(torch.zeros((4, 128), dtype=torch.int32), -1)


# ---- P8: cummax_1d and the counting sorts ------------------------------------
def test_cummax_matches_the_probe_at_block_rows_8():
    """n = 5,000 (not a multiple of 128) with negatives and zeros, through
    the probe's `cummax_1d` at block_rows 8 (Pallas interpret mode: conftest
    sets TRS_INTERPRET=1), and at one block of 512 rows."""
    rng = np.random.default_rng(9)
    x_np = rng.integers(-40, 40, 5000).astype(np.int32)
    x_np[rng.integers(0, 5000, 500)] = 0
    x_np[:100] = -rng.integers(1, 1000, 100)  # a negative head: the identity 0 shows
    want = np.asarray(probe.cummax_1d(jnp.asarray(x_np), block_rows=8))
    got = ek.cummax_1d(torch.from_numpy(x_np), block_rows=8)  # a CPU tensor: the plain version
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.maximum(np.maximum.accumulate(x_np), 0))
    assert np.array_equal(ek.cummax_1d(torch.from_numpy(x_np[:640])).numpy(),
                          np.asarray(probe.cummax_1d(jnp.asarray(x_np[:640]))))


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_counting_sorts_match_numpy_and_each_other(dist):
    """2^16 keys: the matmul-histogram counting sort against the scatter one,
    np.sort and (uniform) the probe's own `counting_sort_u16_matmul`."""
    rng = np.random.default_rng(4)
    n = 1 << 16
    k = (rng.integers(0, 2**16, n) if dist == "uniform"
         else np.minimum(rng.zipf(1.3, n), 2**16 - 1)).astype(np.uint16)
    kt = torch.from_numpy(k.view(np.int16)).view(torch.uint16)
    got = ek.counting_sort_u16_matmul(kt)
    assert got.dtype == torch.uint16
    bits = got.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(bits, np.sort(k))
    assert torch.equal(ek.counting_sort_u16(kt).view(torch.int16), got.view(torch.int16))
    assert torch.equal(ek.matmul_hist_u16(kt), ek.scatter_hist_u16(kt))
    if dist == "uniform":
        want = np.asarray(probe.counting_sort_u16_matmul(jnp.asarray(k)))
        assert np.array_equal(bits, want)


def test_p8_wrappers_refuse_what_they_do_not_take():
    with pytest.raises(TypeError):
        ek.cummax_1d(torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        ek.cummax_1d(torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        ek.cummax_1d(torch.zeros(8, dtype=torch.int32), block_rows=0)
    with pytest.raises(TypeError):
        ek.counting_sort_u16(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        ek.matmul_hist_u16(torch.zeros(12, dtype=torch.int16).view(torch.uint16), blk=8)


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint16, torch.int16, torch.bfloat16])
def test_stage_operation_counts(dtype):
    """P9's operations on the integer lanes, for every lane type: one
    minimum or maximum an element a stage (16 bits: a packed minimum and a
    packed maximum a word of two elements), so the bound at reps 256 is the
    same 2^30 operations for every type."""
    n = ek.TOTAL_ROWS * ek.LANES
    assert n == 1 << 22
    assert ek.stage_ops(dtype, 256, n) == 1 << 30
    assert ek.stage_ops(dtype, 1, 2) == 2
    assert ek.stage_ops(dtype, 0, n) == 0
