"""The padded layout of the distributed sorts, and the batched and
segmented sorts over a mesh, on the CPU: four spawned gloo ranks
(``tests/torch_mesh_worker.py``, suite "layout") through the kernels'
plain versions, every result byte-equal to the JAX package's numpy golden
(per row, per segment). Also `dryrun_multichip` in that world.

The layout cases put real all-ones keys (the sentinel pad's value) on
every shard, with `count` < n and not a multiple of D, uneven shards (one
empty) and many duplicates under the mask: a pad placed at a shard's own
tail would sort among the real keys, or break the exchange's tie
distribution (ROADMAP Queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import tpu_radix_sort as jtrs
import torch_mesh_worker as W
from torch_golden_ref import golden_sort


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return W.start("layout", tmp_path_factory.mktemp("mesh_layout"))


def _eq(got, want):
    if isinstance(want, tuple):
        return isinstance(got, tuple) and len(got) == len(want) and all(
            _eq(g, w) for g, w in zip(got, want))
    got, want = np.asarray(got), np.asarray(want)
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.view(np.uint8), want.view(np.uint8)))


def test_segments_method_validation_matches_jax(world):
    """With `mesh=`, `method` must be 'auto' or 'mesh': the JAX message."""
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("x",))
    msgs = []
    for fn in (jtrs.sort_segments, jtrs.argsort_segments):
        with pytest.raises(ValueError) as e:
            fn(jnp.zeros(64, jnp.uint32), jnp.asarray([0, 64]), mesh=mesh, method="bitonic")
        msgs.append(str(e.value))
    assert world["segments_bad_method"] == "|".join(msgs)


@pytest.mark.parametrize("strategy", ["exchange_d3", "mesh_d4", "exchange_d4"])
@pytest.mark.parametrize("i", range(len(W.layout_variants())))
def test_layout_real_max_keys_beside_pads(world, strategy, i):
    name, k, v, kw = W.layout_variants()[i]
    want = golden_sort(k, **kw) if v is None else golden_sort(k, v, **kw)
    assert _eq(world[f"layout_{strategy}_{name}"], want), name


def test_wrong_axis_name(world):
    assert world["wrong_axis_name"] == "ValueError"


def _rows(k, v=None, **kw):
    out = [golden_sort(r, None if v is None else vr, **kw)
           for r, vr in zip(k, k if v is None else v)]
    if v is None:
        return np.stack(out)
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def test_mesh_sort_batched(world):
    """7 rows over 4 ranks (2, 2, 2, 1), key + value, descending."""
    k = W.batched_input(73, 7, 300)
    v = np.tile(W.iota(300), (7, 1))
    assert _eq(world["batched_kv_desc"], _rows(k, v, descending=True))


def test_mesh_argsort_batched_with_an_empty_rank(world):
    """3 rows over 4 ranks: the last rank has none and returns none."""
    k = W.batched_input(74, 3, 500)
    want = np.stack([np.argsort(r, kind="stable") for r in k]).astype(np.uint32)
    assert _eq(world["argsort_batched_empty_rank"], want)


def test_mesh_sort_batched_u64(world):
    k = W.batched_input(75, 5, 129, np.uint64)
    assert _eq(world["batched_u64_bit_count"], _rows(k, bit_count=40))


def _by_segment(k, offs, v, **kw):
    ks, vs = [], []
    for a, b in zip(offs[:-1], offs[1:]):
        if v is None:
            ks.append(golden_sort(k[a:b], **kw))
        else:
            gk, gv = golden_sort(k[a:b], v[a:b], **kw)
            ks.append(gk)
            vs.append(gv)
    if v is None:
        return np.concatenate(ks)
    return np.concatenate(ks), np.concatenate(vs)


@pytest.mark.parametrize("i", range(len(W.segmented_variants())))
def test_mesh_sort_segments(world, i):
    name, _, k, offs, v, kw = W.segmented_variants()[i]
    assert _eq(world[name], _by_segment(k, offs, v, **kw)), name


def test_mesh_argsort_segments(world):
    k, offs = W.u32(87, 3000, 2**6), W.segments(88, 3000, 40)
    want = np.concatenate([np.argsort(k[a:b], kind="stable")
                           for a, b in zip(offs[:-1], offs[1:])]).astype(np.uint32)
    assert _eq(world["argsort_segments"], want)


def test_dryrun_multichip(world):
    """The twelve checks of the JAX package's multi-chip dry run."""
    assert world["dryrun"] is True


def test_children_import_no_jax(world):
    assert world["_jax_imported"] is False
