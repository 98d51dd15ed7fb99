"""Port parity of ``tpu_radix_sort_torch.benchmarks.explore_stages`` on the
CPU with three columns (key, a unique tie, a payload; two key words): the
cases with k in the tile, each byte-equal to the JAX package's
``_run_network`` in interpret mode, on two tiles of 1,024
(``test_torch_explore_stages.py`` holds the one-column cases,
``test_torch_explore_stages_above.py`` the three-column cases with k above
the tile and the global stages)."""
import pytest

from test_torch_explore_stages import TILE, case_matches_jax_stage_kernel
from tpu_radix_sort_torch.benchmarks import explore_stages as es


@pytest.mark.parametrize("case", ["zero", "one_window", "window_change"])
def test_case_matches_jax_stage_kernel_three_columns(case):
    case_matches_jax_stage_kernel(case, es.COLUMNS[1], n=2 * TILE)
