"""Port parity of ``tpu_radix_sort_torch.benchmarks.explore_stages`` on the
CPU with three columns (key, a unique tie, a payload): the cases with k
above the tile and the global stages (on two tiles of 1,024, where the
global strides are one bit, 10), each byte-equal to the JAX package's
``_run_network`` in interpret mode."""
import pytest

from test_torch_explore_stages import TILE, case_matches_jax_stage_kernel
from tpu_radix_sort_torch.benchmarks import explore_stages as es


@pytest.mark.parametrize("case", ["one_window_k_above", "window_change_k_above", "global"])
def test_case_matches_jax_stage_kernel_three_columns(case):
    case_matches_jax_stage_kernel(case, es.COLUMNS[1], n=2 * TILE)
