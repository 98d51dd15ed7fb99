"""Port parity of the host-side probes of ``tpu_radix_sort_torch.benchmarks``
on the CPU: ``crossover``, ``explore_segmented``, ``explore_msd`` and
``explore_primitives``. Each probe's own ``check`` at small sizes; the
crossover's sorts against the JAX package's native CPU baseline; the
segmented rows against the JAX script's per-segment golden; the msd and
primitives rows, byte for byte, against ``jax.lax.sort`` and ``jnp``
gathers, scatters and products on the same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_radix_sort.runtime import cpu_baseline as jax_cpu
from tpu_radix_sort_torch.benchmarks import (crossover, explore_msd, explore_primitives,
                                             explore_segmented)
from tpu_radix_sort_torch.utils import interop


@pytest.fixture(autouse=True)
def _private_jax_native_cache(tmp_path, monkeypatch):
    """Keep the JAX baseline's build apart from the JAX package's own
    runtime test, which builds the same fixed path."""
    monkeypatch.setenv("TRS_NATIVE_CACHE", str(tmp_path / "jax_native"))


def _np(t):
    return interop.to_numpy(t)


def test_crossover_check_and_jax_baseline():
    sizes = (1 << 10, 1 << 12, 3000)
    assert crossover.check("cpu", sizes=sizes) == 0
    rng = np.random.default_rng(crossover.SEED)
    for n in sizes:
        keys, vals = crossover.inputs(n, rng)
        got = crossover.sort(interop.from_numpy(keys, "cpu"), interop.from_numpy(vals, "cpu"),
                             values_are_ranks=True)
        want = jax_cpu.cpu_sort(keys, vals)
        assert all(np.array_equal(_np(g), w) for g, w in zip(got, want))
    assert crossover.SIZES == tuple(1 << e for e in range(10, 25, 2))


def test_segmented_check_and_rows_against_golden():
    n, s = 1 << 14, 16
    assert explore_segmented.check("cpu", n=n, segments=s) == 0
    keys, offsets, sizes = explore_segmented.make_data(n, s, seed=2)
    # the JAX script's generation (benchmarks/explore_segmented.py:54-62)
    rng = np.random.default_rng(2)
    L = n // s
    delta = rng.integers(-L // 8, L // 8, s).astype(np.int64)
    delta -= delta.sum() // s
    rem = int(delta.sum())
    delta[: abs(rem)] -= np.sign(rem)
    assert np.array_equal(sizes, np.full(s, L, np.int64) + delta)
    assert np.array_equal(offsets, np.concatenate([[0], np.cumsum(sizes)]))
    assert np.array_equal(keys, rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32))
    seg = np.repeat(np.arange(s), sizes)
    want = np.concatenate([np.sort(keys[seg == i]) for i in range(s)])
    k, offs = interop.from_numpy(keys, "cpu"), interop.from_numpy(offsets, "cpu")
    P = explore_segmented.row_pad(sizes)
    assert P == 1 << int(np.ceil(np.log2(sizes.max())))
    assert np.array_equal(_np(explore_segmented.rowlocal_roundtrip(k, offs, P)), want)
    assert np.array_equal(_np(explore_segmented.movement_only(k, offs, P)), keys)
    padded = _np(explore_segmented.gather_pad(k, offs, P)).view(np.uint32)
    for i in (0, s - 1):
        assert np.array_equal(padded[i, : sizes[i]], keys[offsets[i]: offsets[i + 1]])
        assert (padded[i, sizes[i]:] == 0xFFFFFFFF).all()


def _msd_cases():
    return explore_msd.cases("cpu", n=1 << 13, seed=4, row_lengths=(512, 2048), row=2048)


def test_msd_check_on_cpu():
    assert explore_msd.check("cpu", n=1 << 13, row_lengths=(512, 2048), row=2048) == 0


@pytest.mark.parametrize("i", range(8))
def test_msd_row_matches_lax_sort(i):
    tag, fn, args, _ = _msd_cases()[i]
    got = fn(*args)
    got = tuple(_np(g) for g in got) if isinstance(got, tuple) else (_np(got),)
    a = [jnp.asarray(_np(x)) for x in args]
    if tag.startswith("radix"):
        u = a[0].view(jnp.uint32)
        want = (jax.lax.sort((u & 0xF, u), num_keys=1, is_stable=True)[1].view(jnp.int32),)
    elif tag.startswith("bitonic"):
        want = (jax.lax.sort(a[0]),)
    elif "unstable" in tag:
        s, order = jax.lax.sort((a[0], a[1]), dimension=1, num_keys=1, is_stable=True)
        assert np.array_equal(got[0], np.asarray(s))  # keys; the payload is a tie order
        kv = np.sort(got[0].astype(np.int64) << 32 | got[1].astype(np.int64), axis=1)
        want_kv = np.sort(np.asarray(s).astype(np.int64) << 32 | np.asarray(order), axis=1)
        assert np.array_equal(kv, want_kv)
        return
    elif "gather" in tag:
        want = jax.lax.sort(tuple(a), dimension=1, num_keys=1, is_stable=True)
    elif "pad" in tag:
        pad = jnp.full((a[0].shape[0], a[0].shape[1] // 4), explore_msd.SENTINEL_BIASED,
                       jnp.int32)
        want = (jax.lax.sort(jnp.concatenate([a[0], pad], axis=1), dimension=1),)
    else:
        want = (jax.lax.sort(a[0], dimension=1),)
    assert len(got) == len(want)
    assert all(g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w))
               for g, w in zip(got, want))


PRIM = dict(sizes=(1 << 12,), onehot_n=1 << 12, blocks=(256, 512), gather_n=1 << 12, seed=6)


def test_primitives_check_on_cpu():
    assert explore_primitives.check("cpu", **PRIM) == 0


@pytest.mark.parametrize("i", range(9))
def test_primitive_row_matches_jnp(i):
    tag, fn, args, _, _ = explore_primitives.cases("cpu", **PRIM)[i]
    got = fn(*args)
    got = tuple(_np(g) for g in got) if isinstance(got, tuple) else (_np(got),)
    a = [jnp.asarray(_np(x)) for x in args]
    if fn is explore_primitives.add_one:
        want = (a[0] + 1,)
    elif fn is explore_primitives.sort_keys:
        want = (jax.lax.sort(a[0], is_stable=True),)
    elif fn is explore_primitives.sort_kv:
        want = jax.lax.sort((a[0], a[1]), num_keys=1, is_stable=True)
    elif fn is explore_primitives.gather:
        want = (a[0][a[1]],)
    elif fn is explore_primitives.scatter:
        want = (jnp.zeros_like(a[0]).at[a[1]].set(a[0], unique_indices=True),)
    else:  # the bf16 one-hot product, as the JAX script computes it
        oh = jax.lax.bitcast_convert_type(a[0], jnp.bfloat16)
        x = jax.lax.bitcast_convert_type(a[1], jnp.bfloat16)
        prod = jnp.einsum("nij,nj->ni", oh, x, preferred_element_type=jnp.float32)
        want = (jax.lax.bitcast_convert_type(prod.astype(jnp.bfloat16), jnp.uint16),)
    assert len(got) == len(want)
    assert all(g.dtype == np.asarray(w).dtype and np.array_equal(g, np.asarray(w))
               for g, w in zip(got, want))


def test_primitive_rows_cover_the_jax_script():
    rows = explore_primitives.cases("cpu", sizes=(1 << 10, 1 << 11), onehot_n=1 << 11,
                                    blocks=(256, 512, 1024), gather_n=1 << 11)
    tags = [r[0] for r in rows]
    assert len(rows) == 2 * 5 + 3 + 2 and tags[:5] == tags[5:10]
    assert [r[4] for r in rows[:5]] == [8 << 10, None, None, 12 << 10, 12 << 10]
    perm = rows[3][2][1]
    assert perm.dtype == torch.int64 and torch.equal(torch.sort(perm)[0],
                                                     torch.arange(1 << 10))
    w = rows[-1][2][1]
    assert torch.equal(w // explore_primitives.WINDOW,
                       torch.arange(1 << 11) // explore_primitives.WINDOW)
