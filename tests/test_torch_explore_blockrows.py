"""Port parity of ``tpu_radix_sort_torch.benchmarks.explore_blockrows`` on
the CPU: the padded sweeps' ``sort_padded`` rows byte-equal to the JAX
package's ``bitonic.sort_padded`` (interpret mode) on the same seeded
columns, at every listed tile; the probe's own ``check``; the tiles it
lists and the one it marks as ``choose_tile``'s."""
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_radix_sort.ops import bitonic as jbitonic
from tpu_radix_sort_torch.benchmarks import explore_blockrows as eb
from tpu_radix_sort_torch.ops import bitonic
from tpu_radix_sort_torch.utils import dispatch, interop

N = 128  # the shortest padded length


@pytest.mark.parametrize("n_arr", [3, 6])
def test_sort_padded_rows_match_jax(n_arr):
    keys, k, tie = eb.inputs(N, 7 + n_arr, "cpu")
    keys[: N // 4] = keys[0]  # ties: the tie column decides
    k = interop.from_numpy(keys, "cpu")
    tie_np = interop.to_numpy(tie)
    want = jbitonic.sort_padded(
        (jnp.asarray(keys), *[jnp.asarray(tie_np)] * (n_arr - 1)), stable=True)
    want = [np.asarray(w) for w in want]
    cand = next(c for s, a, c in eb.SWEEPS if s == "sort_padded" and a == n_arr)
    for t in eb.tiles(n_arr, cand):
        got = [interop.to_numpy(o) for o in eb.sweep_fn("sort_padded", n_arr, t, tie)(k)]
        assert len(got) == n_arr
        assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))


def test_check_on_cpu():
    assert eb.check("cpu", n=1 << 12) == 0


def test_tiles_fit_the_shared_memory_budget():
    for _, n_arr, cand in eb.SWEEPS:
        listed = eb.tiles(n_arr, cand)
        assert listed and all(n_arr * t * 4 <= dispatch.SMEM_BUDGET_BYTES for t in listed)
        assert all(n_arr * t * 4 > dispatch.SMEM_BUDGET_BYTES for t in cand if t not in listed)
    assert eb.tiles(6, (1024, 2048, 4096, 8192, 16384)) == [1024, 2048, 4096, 8192]
    assert eb.tiles(2, (16384, 32768)) == [16384]


def test_marked_tile_is_the_default_calls():
    """The tile main marks, ``resolve_tile``'s, is the largest listed one."""
    chosen = [bitonic.resolve_tile(eb.N, a) for _, a, _ in eb.SWEEPS]
    assert chosen == [16384, 8192, 16384, 32768]
    assert chosen == [max(eb.tiles(a, c)) for _, a, c in eb.SWEEPS]
