"""Port parity of ``tpu_radix_sort_torch.examples.demo_mesh`` on the CPU:
one world of 4 spawned gloo ranks (u32 key + value, both strategies, the
scan and the order checks); rank 0's gathered results are byte-equal to
the JAX package's golden and to the port's single-device ``sort``. (The
JAX demo needs its virtual devices set before JAX starts, so the JAX
golden, not the JAX demo, is the reference here.)"""
import argparse
import contextlib
import io

import numpy as np
import pytest

import tpu_radix_sort_torch as trt
from torch_golden_ref import golden_sort
from tpu_radix_sort.models.golden import golden_prefix_sum
from tpu_radix_sort_torch.examples import demo_mesh

N, SEED = 6001, 5
MESH, EXCHANGE = "mesh_sort (compare-split)", "exchange_sort (exact splitters)"


@pytest.fixture(scope="module")
def world():
    argv = ["--device", "cpu", "--devices", "4", "--n", str(N), "--values", "--scan",
            "--seed", str(SEED)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):  # the parent's lines, not the ranks'
        res = demo_mesh.main(argv)
    return res, demo_mesh.make_inputs(demo_mesh.parser().parse_args(argv)), out.getvalue()


def _same(got, want):
    return all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))


def test_world_is_four_gloo_ranks_on_the_cpu(world):
    res, _, _ = world
    assert res["backend"] == "gloo" and res["rank_devices"] == ["cpu"] * 4
    assert res["cards"] == 0
    assert [r["case"] for r in res["rows"]] == [
        MESH, EXCHANGE, "prefix_sum (mesh)", "disorder_count (mesh)",
        "is_sorted of sorted input (mesh)"]
    assert all(r["golden_exact"] for r in res["rows"])
    assert sum(res["launches"].values()) == 0  # the CPU runs the plain versions


@pytest.mark.parametrize("strategy", [MESH, EXCHANGE])
def test_strategy_matches_jax_golden_and_single_device_sort(world, strategy):
    res, (keys, values), _ = world
    got = res["outputs"][strategy]
    assert _same(got, golden_sort(keys, values))
    single = trt.sort(keys, values, device="cpu")
    assert _same(got, tuple(s.numpy() for s in single))


def test_scan_and_checks_match_jax_golden(world):
    res, (keys, _), _ = world
    small = (keys % 100).astype(np.uint32)
    assert _same((res["outputs"]["prefix_sum (mesh)"][0],), (golden_prefix_sum(small),))
    assert res["outputs"]["disorder_count (mesh)"] == int(np.sum(keys[:-1] > keys[1:]))
    assert res["outputs"]["is_sorted of sorted input (mesh)"] is True


def test_first_line_names_backend_devices_and_cards(world):
    first = world[2].splitlines()[0]
    assert first == ("mesh: 4 ranks, backend gloo, rank devices ['cpu', 'cpu', 'cpu', 'cpu'], "
                     "0 CUDA card(s)")


def test_inputs_are_the_jax_demos():
    """The same numpy generation from --seed as examples/demo_mesh.py."""
    for skew, dtype in ((False, "uint32"), (True, "uint32"), (False, "uint64"),
                        (True, "uint64")):
        args = argparse.Namespace(n=100, seed=3, skew=skew, dtype=dtype, values=True)
        rng = np.random.default_rng(3)
        wide = dtype == "uint64"
        if skew:
            want = rng.zipf(1.3, size=100).astype(np.uint64 if wide else np.uint32)
        elif wide:
            want = rng.integers(0, 2**64, 100, dtype=np.uint64)
        else:
            want = rng.integers(0, 2**32, 100, dtype=np.uint64).astype(np.uint32)
        keys, values = demo_mesh.make_inputs(args)
        assert keys.dtype == want.dtype and np.array_equal(keys, want)
        assert np.array_equal(values, np.arange(100, dtype=np.uint32))


def test_nccl_needs_a_card_a_rank(capsys):
    with pytest.raises(SystemExit) as e:
        demo_mesh.main(["--device", "cpu", "--devices", "2", "--backend", "nccl"])
    assert e.value.code == 2 and "nccl needs one card a rank" in capsys.readouterr().err
