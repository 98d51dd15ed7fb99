"""Probe P9 on the port (`tpu_radix_sort_torch/benchmarks/explore_keys16.py`,
its kernel through the plain version on the CPU) against the probe's own
JAX body, `benchmarks/explore_keys16.py` `_stage_kernel`, run by
`pl.pallas_call` in interpret mode over 2 x 2,048 rows (the probe's block)
for int32, uint16, int16 and bfloat16, byte for byte (tolerance 0: the
stages only pick one of two values, or a NaN, which must be the JAX one).

The rows are seeded random patterns; the first 64 hold the values where
lane types disagree: NaNs of both signs and several payloads, subnormals,
-0.0 and +0.0, infinities."""
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
    f = pl.pallas_call(
        functools.partial(probe._stage_kernel, reps=reps, dtype=x_np.dtype),
        grid=(ROWS // BLOCK,),
        in_specs=[pl.BlockSpec((BLOCK, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((BLOCK, 128), lambda i: (i, 0)),
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


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        ek.stage_kernel(torch.zeros((4, 128), dtype=torch.float32))
    with pytest.raises(ValueError):
        ek.stage_kernel(torch.zeros((4, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        ek.stage_kernel(torch.zeros((4, 128), dtype=torch.int32), -1)
