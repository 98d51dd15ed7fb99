"""Port parity of the mesh scan and order checks on the CPU: four spawned
gloo ranks (``tests/torch_mesh_worker.py``, suite "check_scan") run
`prefix_sum(mesh=)`, `is_sorted(mesh=)` and `disorder_count(mesh=)`
through the kernels' plain versions (K4, K2, K3). Every result is
byte-equal to the numpy golden (the port's exact uint64 scan, the JAX
golden's order check), and at D = 2 to the JAX `mesh_prefix_sum`,
`mesh_is_sorted` and `mesh_disorder_count` on a two-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_mesh_worker as W
from tpu_radix_sort.models import golden as jax_golden
from tpu_radix_sort.parallel import check as jcheck
from tpu_radix_sort.parallel import scan as jscan
from tpu_radix_sort.parallel.mesh_sort import sharded as jsharded
from tpu_radix_sort_torch.models.golden import golden_prefix_sum


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.start("check_scan", tmp_path_factory.mktemp("mesh_check_scan"))


def _mesh2():
    return Mesh(np.array(jax.devices("cpu")[:2]), ("x",))


def test_checks_match_jax_at_two_devices(world):
    """First in the file, so that the world runs its cases meanwhile."""
    k = W.u32(66, 512, 2**8)
    k[:300] = np.sort(k[:300])
    mesh = _mesh2()
    x = jsharded(mesh, "x", jnp.asarray(k))
    want = [
        bool(jax.jit(lambda a: jcheck.mesh_is_sorted(a, mesh=mesh, count=300))(x)),
        bool(jax.jit(lambda a: jcheck.mesh_is_sorted(a, mesh=mesh))(x)),
        int(jax.jit(lambda a: jcheck.mesh_disorder_count(a, mesh=mesh, count=400))(x)),
        int(jax.jit(lambda a: jcheck.mesh_disorder_count(a, mesh=mesh, bit_count=4))(x)),
    ]
    got = world["jax_checks_d2"].reshape(2, 4)
    assert (got == np.array(want)).all(), (got, want)


def test_scan_matches_jax_at_two_devices(world):
    x = W.scan_items(57, 512, hi=2**32)
    mesh = _mesh2()
    want = jax.jit(lambda a: jscan.mesh_prefix_sum(a, mesh=mesh, count=400))(
        jsharded(mesh, "x", jnp.asarray(x)))
    assert np.array_equal(world["jax_scan_d2"], np.asarray(want))
    assert np.array_equal(world["jax_scan_d2"], golden_prefix_sum(x, count=400))


def _inclusive(x, count):
    out = x.copy()
    u = x[:count].view(np.uint32).astype(np.uint64)
    out[:count] = np.cumsum(u).astype(np.uint32).view(x.dtype)
    return out


def _scan_d4_count():
    x = W.scan_items(51, 5000)
    return golden_prefix_sum(x, count=3333), _inclusive(x, 3333)


def _scan_wrap_int32():
    return (golden_prefix_sum(W.scan_items(52, 3000, hi=2**32)),
            _inclusive(W.scan_items(53, 3000, np.int32), 3000))


SCANS = {
    "scan_d2": lambda: golden_prefix_sum(W.scan_items(50, 1000)),
    "scan_d4_count": _scan_d4_count,
    "scan_wrap_int32": _scan_wrap_int32,
    "scan_uneven": lambda: golden_prefix_sum(W.scan_items(54, 700, hi=2**32), count=420),
    "scan_count_0_d3": lambda: W.scan_items(55, 10),
    "scan_kernel_class": lambda: _inclusive(W.scan_items(56, 3000), 2500),
}


@pytest.mark.parametrize("name", sorted(SCANS))
def test_mesh_prefix_sum_matches_golden(world, name):
    got, want = world[name], SCANS[name]()
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), name


def _golden_disorder(k, count=None, bit_count=None, total_order=False, descending=False):
    """Adjacent descents of the key view that the JAX golden's
    `golden_is_sorted` checks (bijection, mask, then flip)."""
    g = jax_golden
    n = k.shape[0] if count is None else count
    if g._is_64bit(k):
        u, width = (g._total_order_u64(k) if total_order else g._bit_pattern_u64(k)), 64
    elif g._is_16bit(k):
        u = g._total_order_u16_widened(k) if total_order else g._bit_pattern_u16_widened(k)
        width = 16
    else:
        u, width = (g._total_order_u32(k) if total_order else g._bit_pattern_u32(k)), 32
    mask = (1 << (width if bit_count is None else bit_count)) - 1
    m = u[:n].astype(np.uint64) & np.uint64(mask)
    if descending:
        m = m ^ np.uint64(mask)
    return int((m[:-1] > m[1:]).sum())


@pytest.mark.parametrize("i", range(len(W.check_inputs())))
def test_mesh_checks_match_golden(world, i):
    """`is_sorted(mesh=)` and `disorder_count(mesh=)` against the JAX
    golden's `golden_is_sorted` and a count of the descents of its key
    view; every rank returns the same."""
    name, k, kw = W.check_inputs()[i]
    got = world["checks_d4"][i].reshape(4, 2)
    assert (got == got[0]).all(), name
    assert bool(got[0, 0]) == jax_golden.golden_is_sorted(k, **kw), name
    assert got[0, 1] == _golden_disorder(k, **kw), name


def test_mesh_checks_empty_shards(world):
    """Shards of 0-3 elements, some empty: the boundary pairs join
    neighbouring non-empty shards."""
    got = world["checks_uneven_d4"]
    keys = ([5, 3, 4], [1, 2, 3], [4, 1, 2, 3, 9])
    want = [(int(np.sum(np.diff(k) < 0)) == 0, int(np.sum(np.diff(k) < 0))) for k in keys]
    assert want == [(False, 1), (True, 0), (False, 1)]
    for g, (s, c) in zip(got, want):
        rows = g.reshape(4, 2)
        assert (rows == rows[0]).all() and bool(rows[0, 0]) == s and rows[0, 1] == c


def test_children_import_no_jax(world):
    assert world["_jax_imported"] is False
