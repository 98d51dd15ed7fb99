"""Port parity of `mesh_sort` and `sort(mesh=)` on the CPU: four spawned gloo
ranks (``tests/torch_mesh_worker.py``, suite "sort") run each case through
the kernels' plain versions; every result is byte-equal to the JAX
package's numpy golden, and at D = 2 to the JAX `mesh_sort` itself on a
two-device CPU mesh. Also the compare-split select against JAX's, and the
strategy that 'auto' resolves to."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_mesh_worker as W
from torch_golden_ref import golden_sort
from tpu_radix_sort_torch.ops import sort as sort_mod

# each package's `parallel.mesh_sort` attribute is the function: the modules
jmesh_sort_mod = importlib.import_module("tpu_radix_sort.parallel.mesh_sort")
mesh_sort_mod = importlib.import_module("tpu_radix_sort_torch.parallel.mesh_sort")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.start("sort", tmp_path_factory.mktemp("mesh_sort"))


def test_mesh_sort_matches_jax_at_two_devices(world):
    """The JAX `mesh_sort` on a two-device CPU mesh, the same seeded input:
    byte-equal to the port's D = 2 ranks. First in the file, so that the
    world runs its cases meanwhile."""
    k, v = W.u32(24, 512, 2**6), W.iota(512)
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("x",))
    fn = jax.jit(lambda a, b: jmesh_sort_mod.mesh_sort(a, b, mesh=mesh, count=500))
    jk, jv = fn(jmesh_sort_mod.sharded(mesh, "x", jnp.asarray(k)),
                jmesh_sort_mod.sharded(mesh, "x", jnp.asarray(v)))
    assert _eq(world["jax_d2"], (np.asarray(jk), np.asarray(jv)))


def _eq(got, want):
    """Byte equality of a result (array or tuple) with the expected one."""
    if isinstance(want, tuple):
        return isinstance(got, tuple) and len(got) == len(want) and all(
            _eq(g, w) for g, w in zip(got, want))
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.view(np.uint8), want.view(np.uint8)))


def _kv_count():
    return golden_sort(W.u32(4, 3000, 2**10), W.iota(3000), count=2222)


def _overlap():
    return golden_sort(W.u32(11, 6000, 2**8), W.iota(6000), count=5000)


def _f16():
    return golden_sort(W.neg_floats(9, 700).astype(np.float16), W.iota(700), total_order=True)


def _i16():
    k = np.random.default_rng(10).integers(-2**15, 2**15, 900).astype(np.int16)
    return golden_sort(k, bit_count=12, descending=True)


def _boundary_only():
    k = np.concatenate([np.sort(W.u32(14 + i, 512)) for i in range(4)])[::-1].copy()
    return np.sort(k)


def _u64_count():
    k, v = W.u64_hi_dups(21, 2048), np.arange(2048, dtype=np.uint64) * np.uint64(3**30)
    return golden_sort(k, v, bit_count=16, count=1999)


def _i64_f64():
    rng = np.random.default_rng(22)
    i = rng.integers(-(2**62), 2**62, 1024).astype(np.int64)
    f = rng.standard_normal(1024)
    return golden_sort(i, total_order=True), golden_sort(f, total_order=True)


def _packed():
    k, v = golden_sort(W.u32(18, 600, 2**8), W.iota(600))
    return np.stack([k, v], axis=1)


GOLDEN = {
    "keys_d1": lambda: golden_sort(W.u32(1, 256)),
    "keys_d2": lambda: golden_sort(W.u32(2, 1000)),
    "keys_d4": lambda: golden_sort(W.u32(3, 4096)),
    "kv_count_d2": _kv_count,
    "kv_count_d4": _kv_count,
    "bit_count_kv": lambda: golden_sort(W.u32(5, 3000), W.iota(3000), bit_count=8),
    "float_keys": lambda: golden_sort(
        np.random.default_rng(6).random(2048, dtype=np.float32) * 100),
    "descending_kv": lambda: golden_sort(W.u32(7, 1000, 2**8), W.iota(1000), descending=True),
    "total_order_kv": lambda: golden_sort(W.neg_floats(8, 1500), W.iota(1500),
                                          total_order=True),
    "f16_total_order": _f16,
    "i16_bit_count_desc": _i16,
    "overlap_2": _overlap,
    "overlap_4": _overlap,
    "check_order_boundary_only": _boundary_only,
    "argsort_uneven": lambda: np.argsort(W.u32(17, 1000, 2**7), kind="stable").astype(np.uint32),
    "sort_packed": _packed,
    "u64_kv": lambda: golden_sort(W.u64_hi_dups(19, 2048), W.iota(2048)),
    "u64_bit_count_40_desc": lambda: golden_sort(W.u64_hi_dups(20, 2048), bit_count=40,
                                                 descending=True),
    "u64_bit_count_16_count": _u64_count,
    "i64_f64_total_order": _i64_f64,
    "kernel_class": lambda: golden_sort(W.u32(23, 2000, 2**8), W.iota(2000), count=1500),
    "jax_d2": lambda: golden_sort(W.u32(24, 512, 2**6), W.iota(512), count=500),
}


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_mesh_sort_matches_golden(world, name):
    assert _eq(world[name], GOLDEN[name]()), name


@pytest.mark.parametrize("sorted_input", [True, False])
def test_check_order_gate(world, sorted_input):
    """A globally sorted input comes back unchanged without a network call;
    an unsorted one is sorted."""
    k, v = W.u32(13, 3000, 2**9), W.iota(3000)
    want = golden_sort(k, v)
    name = "check_order_sorted" if sorted_input else "check_order_unsorted"
    *out, calls = world[name]
    assert _eq(tuple(out), want)
    assert (calls == 0).all() if sorted_input else (calls > 0).all()


@pytest.mark.parametrize("method,strategy", [("auto", 0), ("mesh", 0), ("exchange", 1)])
def test_sort_mesh_routing(world, method, strategy):
    """`sort(mesh=)` at D = 4: 'auto' and 'mesh' run the compare-split
    network, 'exchange' the radix exchange; `values_are_ranks` is ignored."""
    *out, calls = world[f"routed_{method}"]
    assert _eq(tuple(out), golden_sort(W.u32(15, 2500, 2**9), W.iota(2500)))
    per_rank = calls.reshape(-1, 2)
    assert (per_rank[:, strategy] == 1).all() and (per_rank[:, 1 - strategy] == 0).all()


def test_mesh_errors(world):
    assert world["overlap_validation"] == "ValueError"
    assert world["routed_bad_method"] == "ValueError"
    assert world["_jax_imported"] is False


@pytest.mark.parametrize("n_dev,want", [(1, "mesh"), (2, "mesh"), (3, "exchange"),
                                        (4, "mesh"), (5, "exchange"), (6, "exchange"),
                                        (7, "exchange"), (8, "exchange")])
def test_auto_resolution(n_dev, want):
    """'auto' takes the network at 4 ranks or fewer, as the JAX package's
    `sort` does (`mesh.shape[axis] <= 4`), the exchange above, and the
    exchange at 3, where the network (a power of two) cannot run."""
    assert sort_mod._resolve_mesh_method("auto", n_dev) == want
    assert sort_mod._resolve_mesh_method("exchange", n_dev) == "exchange"
    with pytest.raises(ValueError):
        sort_mod._resolve_mesh_method("radix", n_dev)


@pytest.mark.parametrize("keep_min", [True, False])
def test_compare_split_ce_matches_jax(keep_min):
    """The compare-split select on one pair of sorted blocks, the partner's
    reversed: byte-equal to JAX's `_compare_split_ce`."""
    rng = np.random.default_rng(25)
    x = np.sort(rng.integers(0, 50, (3, 256)).astype(np.uint32), axis=1)
    x[1] = np.arange(256)
    y = np.sort(rng.integers(0, 50, (3, 256)).astype(np.uint32), axis=1)
    y[1] = np.arange(256, 512)
    recv = y[:, ::-1].copy()
    want = jmesh_sort_mod._compare_split_ce(
        tuple(jnp.asarray(c) for c in x), tuple(jnp.asarray(c) for c in recv), keep_min, 2)
    got = mesh_sort_mod._compare_split_ce(
        torch.from_numpy(x.view(np.int32)), torch.from_numpy(recv.view(np.int32)), keep_min, 2)
    assert _eq(got.numpy().view(np.uint32), np.stack([np.asarray(w) for w in want]))
