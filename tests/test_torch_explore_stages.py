"""Port parity of ``tpu_radix_sort_torch.benchmarks.explore_stages`` on the
CPU: every case's stage list, run through the port's K1 wrappers (their
plain version here), is byte-equal to the JAX package's ``_run_network``
(the Pallas stage kernel in interpret mode) on the same seeded columns, on
a small grid, for one column here and for three (key, tie, payload) in
``test_torch_explore_stages_wide.py``; the probe's own ``check``; the
cases' stage lists and bounds."""
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_radix_sort.ops import bitonic as jbitonic
from tpu_radix_sort.ops import common as jcommon
from tpu_radix_sort_torch.benchmarks import explore_stages as es
from tpu_radix_sort_torch.ops import bitonic
from tpu_radix_sort_torch.utils import interop

N, TILE = 1 << 12, 1 << 10  # chunk bits 10: windows 0 and 5
LANES = jbitonic.LANES


def _jax_network(x, stages, n_keys, block):
    """The JAX stage kernel over blocks of `block` elements of the (n_arr,
    n) u32 columns x, interpret mode."""
    n_arr, n = x.shape
    rows, tile_rows = n // LANES, block // LANES
    arrs = tuple(jnp.asarray(c.reshape(rows, LANES)) for c in x)
    out = jbitonic._run_network(
        arrs, n_keys == 2, stages, grid=(rows // tile_rows,), block_shape=(tile_rows, LANES),
        index_map=lambda i: (i, jcommon.IM0), base_scale=block, kernel_rows=tile_rows,
        block_elems=block, interpret=True, n_keys=n_keys)
    return np.stack([np.asarray(o).reshape(-1) for o in out])


def case_matches_jax_stage_kernel(case, columns, n=N):
    n_arr, n_keys = columns
    x0 = es.inputs(n_arr, n, 3 + n_arr, "cpu")
    got = interop.to_numpy(es.run_case(x0.clone(), case, n_keys, TILE)).view(np.uint32)
    stages = es.case_stages(case, TILE, n)
    # the global strides span blocks: JAX runs them over one block of all n
    want = _jax_network(interop.to_numpy(x0).view(np.uint32), stages, n_keys,
                        n if case == "global" else TILE)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("case", es.CASES)
def test_case_matches_jax_stage_kernel(case):
    case_matches_jax_stage_kernel(case, es.COLUMNS[0])


def test_check_on_cpu():
    assert es.check("cpu", n=1 << 13, tile=TILE) == 0


def test_case_stage_lists():
    L = bitonic.chunk_bits(es.TILE)
    for case in es.CASES[1:]:
        stages = es.case_stages(case)
        assert len(stages) == es.STAGES
        if case != "global":
            assert all((k == es.K_ABOVE) == case.endswith("k_above") for k, _ in stages)
    one = es.case_stages("one_window")
    assert {j.bit_length() - 1 for _, j in one} == set(range(5, 10))
    assert all(k == 2 * j for k, j in one)
    assert bitonic.tile_plan(one, es.TILE) == [(5, one)]
    change = es.case_stages("window_change")
    assert [j.bit_length() - 1 for _, j in change[:4]] == [0, L - 4, 1, L - 3]
    plan = bitonic.tile_plan(change, es.TILE)
    assert len(plan) == es.STAGES and [w for w, _ in plan][::2] == [0] * 8
    assert {j.bit_length() - 1 for _, j in es.case_stages("global")} == set(range(L, 24))
    assert es.case_stages("zero") == []


def test_bounds_and_ops():
    assert es.ops_per_pair(1, 1, "one_window") == 2
    assert es.ops_per_pair(3, 2, "one_window") == 6 and es.ops_per_pair(3, 2, "global") == 8
    t, by = es.bound_ms("zero", 3, 2)
    assert by == "bytes" and t == pytest.approx(2 * 3 * 4 * es.N / 3.35e12 * 1e3)
    t, by = es.bound_ms("global", 1, 1)
    assert by == "bytes" and t == pytest.approx(16 * 4 * es.N / 3.35e12 * 1e3)
