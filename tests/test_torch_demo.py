"""Port parity of ``tpu_radix_sort_torch.examples.demo`` on the CPU: each
mode's output, from the keys the demo makes from its seed, is byte-equal to
the JAX package's ``RadixSortKernel`` / ``RadixSortPackedKernel`` / ``sort``
on the same keys and to the JAX golden; the argument errors are the JAX
demo's. The JAX side runs ``method='xla'`` (byte-identical to its Pallas
engines by the package's contract) except in the keys-only case, which runs
the default Pallas engine in interpret mode."""
import contextlib
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_radix_sort as jtrs
from torch_golden_ref import golden_sort
from tpu_radix_sort_torch.examples import demo

N = 5000
CASES = {
    "keys": [],
    "values": ["--values"],
    "ranks": ["--values", "--ranks"],
    "packed": ["--packed"],
    "uint64": ["--dtype", "uint64", "--values"],
    "radix": ["--method", "radix", "--values"],
    "sorted_check_consecutive": ["--sorted", "--check-order", "--consecutive", "3"],
    "tile_bit_count": ["--values", "--tile", "256", "--block-rows", "8", "--bit-count", "20"],
}


@contextlib.contextmanager
def _x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _jax_reference(case, flags, r):
    keys = r["keys"]
    vals = np.arange(N, dtype=np.uint32)
    values = "--values" in flags
    bit_count = int(flags[flags.index("--bit-count") + 1]) if "--bit-count" in flags else None
    method = "auto" if case == "keys" else "xla"
    if case == "packed":
        out = jtrs.RadixSortPackedKernel(count=N, method=method).dispatch(
            jnp.asarray(r["packed"]))
        return np.asarray(out)
    if case == "uint64":
        with _x64():
            k, v = jtrs.sort(jnp.asarray(keys), jnp.asarray(vals), method=method)
            return np.asarray(k), np.asarray(v)
    kern = jtrs.RadixSortKernel(count=N, has_values=values, values_are_ranks="--ranks" in flags,
                                check_order="--check-order" in flags, method=method,
                                **({"bit_count": bit_count} if bit_count else {}))
    out = kern.dispatch(jnp.asarray(keys), jnp.asarray(vals)) if values else kern.dispatch(
        jnp.asarray(keys))
    return tuple(np.asarray(o) for o in out) if values else np.asarray(out)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
        for g, w in zip(got, want))


@pytest.mark.parametrize("case", list(CASES))
def test_demo_output_matches_jax_and_golden(case):
    flags = CASES[case]
    r = demo.main(["--device", "cpu", "--n", str(N), "--seed", str(len(case)), *flags])
    assert r["timer"] == "host wall" and r["t_dev"] > 0 and r["t_cpu"] > 0
    assert r["cpu_kind"] == ("numpy" if case == "uint64" else "native radix")
    assert _same(r["out"], _jax_reference(case, flags, r))
    keys, vals = r["keys"], np.arange(N, dtype=np.uint32)
    bit_count = 20 if "--bit-count" in flags else None
    if case == "packed":
        gk, gv = golden_sort(keys, vals)
        want = np.stack([gk, gv], -1).reshape(r["packed"].shape)
    elif "--values" in flags:
        want = golden_sort(keys, vals, bit_count=bit_count)
    else:
        want = golden_sort(keys)
    assert _same(r["out"], want)
    if "--consecutive" in flags:
        # frames 2+ re-sort frame 1's output: the same sorted keys
        assert r["t_rest"] > 0 and _same(r["fed_out"], want)
        assert np.array_equal(keys, np.sort(keys))  # --sorted


def test_demo_keys_are_the_jax_demos():
    """The same numpy generation from --seed as examples/demo.py."""
    rng = np.random.default_rng(11)
    want = rng.integers(0, 2**32, size=100, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(demo.make_keys(100, 11, False, False), want)
    want64 = np.random.default_rng(11).integers(0, 2**64, size=100, dtype=np.uint64)
    assert np.array_equal(demo.make_keys(100, 11, True, True), np.sort(want64))
    assert [demo.packed_width(n) for n in (8192 * 3, 4096, 3072, 384, 7)] == [
        8192, 4096, 1024, 128, 1]


def _jax_demo():
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "demo.py")
    spec = importlib.util.spec_from_file_location("jax_examples_demo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ERRORS = {
    "packed_values": (["--packed", "--values"], "--packed implies key+value"),
    "ranks_consecutive": (["--values", "--ranks", "--consecutive", "2"], "--ranks with"),
    "uint64_packed": (["--dtype", "uint64", "--packed"], "--dtype uint64 unsupported"),
    "bad_method": (["--method", "gpu"], "invalid choice"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_demo_argument_errors_are_the_jax_demos(case, capsys, monkeypatch):
    argv, message = ERRORS[case]
    with pytest.raises(SystemExit) as port:
        demo.main(["--device", "cpu", "--n", "64", *argv])
    assert port.value.code == 2 and message in capsys.readouterr().err
    monkeypatch.setattr(sys, "argv", ["demo.py", "--n", "64", *argv])
    with pytest.raises(SystemExit) as ref:
        _jax_demo().main()
    assert ref.value.code == 2 and message in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the CPU-only behaviour")
def test_demo_needs_the_card_unless_asked():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--n", "64"])
