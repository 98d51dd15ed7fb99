"""Port parity of `exchange_sort` on the CPU: four spawned gloo ranks
(``tests/torch_mesh_worker.py``, suite "exchange") run each case through
the kernels' plain versions; every result is byte-equal to the JAX
package's numpy golden. Both branches of phase 4 (the slotted merge tree
and the re-sort of contiguous chunks) run, at D = 3 and 4. The splitter's
split positions equal JAX `_select_splits`'s on the same sorted shards,
and the ragged exchange delivers what JAX's `ragged_all_to_all_emulated`
delivers."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_mesh_worker as W
from torch_golden_ref import golden_sort
from tpu_radix_sort.parallel import radix_exchange as jrx


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.start("exchange", tmp_path_factory.mktemp("mesh_exchange"))


def _jax_mesh(d):
    return Mesh(np.array(jax.devices("cpu")[:d]), ("x",))


def test_select_splits_matches_jax(world):
    """s_mid of every rank at D = 4, L = 1,024, heavy duplicates and a tie
    run across a boundary. First in the file: the world runs meanwhile."""
    k = W.select_splits_input()
    L = k.shape[0] // 4
    targets = jnp.arange(1, 4, dtype=jnp.uint32) * jnp.uint32(L)
    fn = jax.jit(jax.shard_map(
        functools.partial(jrx._select_splits, targets=targets, axis_name="x", n_dev=4),
        mesh=_jax_mesh(4), in_specs=P("x"), out_specs=P("x"), check_vma=False))
    want = np.asarray(fn(jnp.asarray(k))).astype(np.int32)
    assert np.array_equal(world["select_splits"], want)


def test_ragged_exchange_matches_jax_emulation(world):
    """`ragged_all_to_all` (all_to_all_v, then each chunk placed at its
    offset) against the JAX emulation on the same metadata: uneven starts,
    sizes from 0, gaps in the output that keep the buffer's value."""
    a, starts, sizes, offs, b = W.ragged_input()
    fn = jax.jit(jax.shard_map(
        lambda x: jrx.ragged_all_to_all_emulated(
            x, jnp.full((b,), 0x5A5A5A5A, jnp.uint32), jnp.asarray(starts),
            jnp.asarray(sizes), jnp.asarray(offs), axis_name="x", n_dev=4),
        mesh=_jax_mesh(4), in_specs=P("x"), out_specs=P("x"), check_vma=False))
    want = np.asarray(fn(jnp.asarray(a)))
    assert np.array_equal(world["ragged"], want)


def _eq(got, want):
    if isinstance(want, tuple):
        return isinstance(got, tuple) and len(got) == len(want) and all(
            _eq(g, w) for g, w in zip(got, want))
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.view(np.uint8), want.view(np.uint8)))


def _f64_i64():
    rng = np.random.default_rng(44)
    f = rng.standard_normal(2048)
    i = rng.integers(-(2**62), 2**62, 2048).astype(np.int64)
    return np.sort(f), np.sort(i)


def _u64_zipf():
    k = (np.uint64(3) << np.uint64(32)) | W.zipf(42, 4096).astype(np.uint64)
    return golden_sort(k, W.iota(4096))


GOLDEN = {
    "keys_d2": lambda: golden_sort(W.u32(30, 512)),
    "keys_d4": lambda: golden_sort(W.u32(31, 4000)),
    "d3_zipf": lambda: golden_sort(W.zipf(36, 2100), W.iota(2100)),
    "bit_count_8_kv": lambda: golden_sort(W.u32(37, 3000), W.iota(3000), bit_count=8),
    "descending_kv": lambda: golden_sort(W.u32(38, 2000, 2**8), W.iota(2000), descending=True),
    "total_order_f32": lambda: golden_sort(W.neg_floats(39, 2000), W.iota(2000),
                                           total_order=True),
    "u64_kv": lambda: golden_sort(W.u64_hi_dups(41, 4096), W.iota(4096)),
    "u64_count": lambda: golden_sort(W.u64_hi_dups(41, 4096), count=3000),
    "u64_bit_count_40_desc": lambda: golden_sort(W.u64_hi_dups(41, 4096), bit_count=40,
                                                 descending=True),
    "u64_bit_count_16": lambda: golden_sort(W.u64_hi_dups(41, 4096), bit_count=16),
    "u64_zipf_lo": _u64_zipf,
    "u64_all_equal": lambda: (np.full(4096, 0x9E3779B97F4A7C15, dtype=np.uint64), W.iota(4096)),
    "u64_d3": lambda: golden_sort(W.u64_hi_dups(43, 1536), W.iota(1536)),
    "f64_i64_total_order": _f64_i64,
    "probe_k8": lambda: (golden_sort(W.u32(45, 4096, 2**12), W.iota(4096)),
                         golden_sort(W.u64_hi_dups(46, 2048))),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_exchange_sort_matches_golden(world, name):
    got = world[name]
    if name == "probe_k8":
        got = (got[:2], got[2])
    assert _eq(got, GOLDEN[name]()), name


# (case, expected, phase-4 branch: 0 the slotted merge tree, 1 the re-sort)
PHASE4 = {
    "kv_dups": (lambda: golden_sort((W.u32(32, 4096) % np.uint32(97)).astype(np.uint32),
                                    W.iota(4096)), 0),
    # count < n: the sentinel pads fill the last block, which stays whole
    "kv_dups_count": (lambda: golden_sort((W.u32(32, 5000) % np.uint32(97)).astype(np.uint32),
                                          W.iota(5000), count=4321), 1),
    "zipf": (lambda: golden_sort(W.zipf(33, 4096, 1.2)), None),
    "all_equal": (lambda: (np.full(4096, 7, dtype=np.uint32), W.iota(4096)), 1),
    "presorted": (lambda: golden_sort(np.sort(W.u32(34, 4096, 2**10)), W.iota(4096)), 1),
    "d3_random": (lambda: golden_sort(W.u32(35, 1536, 2**9), W.iota(1536)), 0),
}


@pytest.mark.parametrize("name", sorted(PHASE4))
def test_exchange_phase4_branches(world, name):
    """Every rank takes the same branch, and the result is the golden's
    either way. Random keys fit their slots; a whole block that stays on
    its rank (all-equal or sorted input) does not."""
    want, branch = PHASE4[name]
    *out, calls = world[name]
    assert _eq(tuple(out) if len(out) > 1 else out[0], want())
    per_rank = calls.reshape(-1, 2)
    assert (per_rank == per_rank[0]).all() and per_rank[0].sum() == 1
    if branch is not None:
        assert per_rank[0, branch] == 1


@pytest.mark.parametrize("sorted_input", [True, False])
def test_exchange_check_order_gate(world, sorted_input):
    k = W.u32(40, 3000, 2**9)
    out, calls = world[f"check_order_{'sorted' if sorted_input else 'unsorted'}"]
    assert _eq(out, np.sort(k))
    assert (calls == 0).all() if sorted_input else (calls > 0).all()


def test_children_import_no_jax(world):
    assert world["_jax_imported"] is False
