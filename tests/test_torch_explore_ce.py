"""Probe P1 on the port (`tpu_radix_sort_torch/benchmarks/explore_ce.py`,
its kernel through the plain version on the CPU) against the probe's own
JAX body, `benchmarks/explore_ce.py` `_kernel`, run by `pl.pallas_call` in
interpret mode on one 1,024 x 128 tile: every variant and column count the
probe runs, byte for byte (tolerance 0, integer work).

The tile holds two inputs, since the stages pair rows only within 512-row
halves: rows 0-511 the probe's own (column i = x + i), rows 512-1023 a
tie-heavy one with independent columns (ties decide which payload each
slot keeps). The interpret-mode body is compiled with XLA's fusion pass
off: fused, the stable 'xorswap' bodies take seconds to compile and run;
the pass changes no integer result. The u64 case runs in JAX's x64 mode,
restored after."""
import contextlib
import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_radix_sort_torch.benchmarks import explore_ce

_SPEC = importlib.util.spec_from_file_location(
    "explore_ce_probe", Path(__file__).resolve().parents[1] / "benchmarks" / "explore_ce.py")
probe = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(probe)

HALF = probe.TILE_ROWS // 2
CASES = sorted(explore_ce.VARIANTS)


@contextlib.contextmanager
def _x64(on):
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _tile(n_arr, variant):
    """(n_arr, 1024, 128) numpy columns: the probe's input over the first
    half, tie-heavy independent columns over the second."""
    rng = np.random.default_rng(7 * n_arr + (variant == "u64"))
    x = rng.integers(0, 2**32, (HALF, probe.LANES), dtype=np.uint64).astype(np.uint32)
    probe_half = np.stack([x + np.uint32(i) for i in range(n_arr)])
    if variant == "u64":
        hi = rng.choice(np.array([0, 7, 0x80000000, 0xFFFFFFFF], np.uint64), (HALF, probe.LANES))
        lo = rng.choice(np.array([0, 1, 0x80000001, 0xFFFFFFFF], np.uint64), (HALF, probe.LANES))
        ties = ((hi << np.uint64(32)) | lo)[None]
        return np.concatenate([probe_half.astype(np.uint64), ties], axis=1), x
    ties = rng.integers(0, 2**32, (n_arr, HALF, probe.LANES), dtype=np.uint64).astype(np.uint32)
    ties[0] = rng.choice(np.array([0, 5, 0x80000000, 0xFFFFFFFF], np.uint32), ties[0].shape)
    if n_arr > 1:
        ties[1] = rng.choice(np.array([1, 2, 0x80000002, 0xFFFFFFFE], np.uint32), ties[1].shape)
    return np.concatenate([probe_half, ties], axis=1), x


@functools.lru_cache(maxsize=None)
def _jax_out(variant, n_arr, stable):
    cols, _ = _tile(n_arr, variant)
    spec = pl.BlockSpec((probe.TILE_ROWS, probe.LANES), lambda i: (i, 0))
    with _x64(variant == "u64"):
        args = [jnp.asarray(c) for c in cols]
        f = pl.pallas_call(
            lambda *refs: probe._kernel(refs, n_arr=n_arr, variant=variant, stable=stable),
            grid=(1,), in_specs=[spec] * n_arr, out_specs=[spec] * n_arr,
            out_shape=[jax.ShapeDtypeStruct(cols.shape[1:], cols.dtype)] * n_arr,
            interpret=True)
        out = jax.jit(f).lower(*args).compile(
            compiler_options={"xla_disable_hlo_passes": "fusion"})(*args)
        return np.stack([np.asarray(o) for o in out])


def _torch_cols(cols):
    view = np.int64 if cols.dtype == np.uint64 else np.int32
    return torch.from_numpy(np.ascontiguousarray(cols.reshape(cols.shape[0], -1)).view(view))


@pytest.mark.parametrize("variant,n_arr,stable", CASES)
def test_plain_matches_the_probe_body(variant, n_arr, stable):
    cols, x = _tile(n_arr, variant)
    t = _torch_cols(cols)
    got = explore_ce.ce_stages(t, variant, stable)  # a CPU tensor: the plain version
    want = _jax_out(variant, n_arr, stable)
    assert np.array_equal(got.numpy().view(want.dtype).reshape(want.shape), want)
    # the probe's input as the port builds it (column i = x + i)
    xt = torch.from_numpy(x.view(np.int32))
    assert np.array_equal(explore_ce.probe_columns(xt, n_arr, variant).numpy(),
                          _torch_cols(cols[:, :HALF]).numpy())
    assert torch.equal(explore_ce.ce_stages(t, variant, stable, n_stages=0), t)


def test_jax_variants_that_compute_one_function():
    """'roll' and 'flip' give the same bytes (1 and 2 stable columns), and so
    do 'xorswap' and 'flipminmax' (1 column): the port maps each pair to one
    function and one kernel instance."""
    for n_arr, stable in ((1, False), (2, True)):
        assert np.array_equal(_jax_out("roll", n_arr, stable), _jax_out("flip", n_arr, stable))
    assert np.array_equal(_jax_out("xorswap", 1, False), _jax_out("flipminmax", 1, False))
    assert not np.array_equal(_jax_out("roll", 1, False), _jax_out("xorswap", 1, False))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    t = torch.zeros((2, explore_ce.T), dtype=torch.int32)
    with pytest.raises(ValueError):
        explore_ce.ce_stages(t, "roll", False)  # 2 columns, not stable: no case
    with pytest.raises(ValueError):
        explore_ce.ce_stages(t[:, :1000].contiguous(), "roll", True)
    with pytest.raises(ValueError):
        explore_ce.ce_stages(t, "roll", True, n_stages=3)
    with pytest.raises(ValueError):
        explore_ce.ce_stages(t, "roll", True, formulation="shuffle")
    with pytest.raises(TypeError):
        explore_ce.ce_stages(t[:1].to(torch.int64), "roll", False)


# ---- the kernel's plan: problems, grid, layout (no kernel launched) --------
def _problem_base(p):
    """csrc/explore_ce.cu `problem_base`: element (row 0, lane 0) of problem
    p, tile p // 16, half (p // 8) % 2, lanes 16 (p % 8) to 16 (p % 8) + 15."""
    groups = explore_ce.LANES // explore_ce.PROBLEM_LANES
    return (p // (2 * groups)) * explore_ce.T + (p // groups) % 2 * explore_ce.PROBLEM_ROWS \
        * explore_ce.LANES + p % groups * explore_ce.PROBLEM_LANES


def _smem_offset(r):
    """csrc/explore_ce.cu `soff`: the shared offset of problem row r, 32 (r >> 1)
    + 16 H(r), H(r) = bit 0 ^ bit 1 ^ bit 5 of r."""
    return (r >> 1) << 5 | ((r ^ r >> 1 ^ r >> 5) & 1) << 4


def _cuda_constants():
    """The `constexpr int` constants of csrc/explore_ce.cu, evaluated in
    order (C's integer arithmetic on the names defined before)."""
    src = (Path(explore_ce.__file__).resolve().parents[1] / "csrc" / "explore_ce.cu").read_text()
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", src, re.M):
        env[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(env))
    return env


def test_python_and_cuda_constants_agree():
    c = _cuda_constants()
    assert (c["kRows"], c["kProbLanes"], c["kProblem"]) == (
        explore_ce.PROBLEM_ROWS, explore_ce.PROBLEM_LANES, explore_ce.PROBLEM) == (512, 16, 8192)
    assert c["kThreads"] == explore_ce.CE_THREADS
    assert c["kTeams"] == explore_ce.CE_BUFFERS
    assert c["kSlots"] == 32  # five row bits in registers
    assert (c["kTileElems"], c["kStages"]) == (explore_ce.T, explore_ce.STAGES)


def test_problems_partition_the_columns_and_hold_every_pair():
    """Problem p is rows 0-511 of one half tile, 16 lanes: the problems of
    two tiles cover every element once, and every stage pairs two elements
    of one problem."""
    assert [_problem_base(p) for p in (0, 1, 7, 8, 15, 16, 31)] == [
        0, 16, 112, 65536, 65536 + 112, 131072, 131072 + 65536 + 112]
    n = 2 * explore_ce.T
    owner = np.full(n, -1)
    rows = np.arange(explore_ce.PROBLEM_ROWS)[:, None] * explore_ce.LANES
    for p in range(n // explore_ce.PROBLEM):
        idx = _problem_base(p) + rows + np.arange(explore_ce.PROBLEM_LANES)
        assert (owner[idx] == -1).all()
        owner[idx] = p
    assert (owner >= 0).all()
    e = np.arange(n)
    for m in sorted(set(explore_ce.MS)):
        assert (owner[e ^ (explore_ce.LANES * m)] == owner).all()


def test_shared_layout():
    """Rows of 16 words at 32 (r >> 1) + 16 H(r), H = bit 0 ^ bit 1 ^ bit 5:
    one problem column fills 8,192 words once, and the rows that the two
    half-warps of an access take (differing in bit 0, 1 or 5) start in
    different halves of the 32 banks."""
    off = [_smem_offset(r) for r in range(explore_ce.PROBLEM_ROWS)]
    assert off[:4] == [0, 16, 48, 32] and off[32:34] == [528, 512]
    words = {o + lane for o in off for lane in range(16)}
    assert words == set(range(explore_ce.PROBLEM))
    for r in range(explore_ce.PROBLEM_ROWS):
        for bit in (1, 2, 32):
            assert off[r] % 32 != off[r ^ bit] % 32


@pytest.mark.parametrize("variant,n_arr,stable,ops", [
    ("roll", 1, False, 2), ("minmax", 1, False, 2), ("xorswap", 1, False, 2),
    ("roll", 2, True, 8), ("fold2minmax", 2, True, 8), ("xorswap", 2, True, 6),
    ("roll", 3, True, 10), ("fold3minmax", 3, True, 10), ("xorswap", 3, True, 8),
    ("u64", 1, False, 6),
])
def test_operation_counts(variant, n_arr, stable, ops):
    assert explore_ce.ops_per_pair(variant, n_arr, stable) == ops
    assert explore_ce.stage_ops(variant, n_arr, stable) == 16 * 2**23 * ops
    # every case moves more bytes than the card's integer lanes take for its
    # counted operations: the bytes bound it
    t, by = explore_ce.bound_ms(variant, n_arr, stable)
    assert by == "bytes" and t == pytest.approx(
        2 * n_arr * (8 if variant == "u64" else 4) * 2**24 / 3.35e12 * 1e3)


@pytest.mark.parametrize("variant,n_arr,stable", CASES)
def test_in_place_on_the_cpu(variant, n_arr, stable):
    cols, _ = _tile(n_arr, variant)
    t = _torch_cols(cols)
    want = explore_ce.ce_plain(t, variant, stable)
    x = t.clone()
    assert explore_ce.ce_stages_into(x, x, variant, stable) is x
    assert torch.equal(x, want)
    with pytest.raises(ValueError):
        explore_ce.ce_stages_into(t, torch.empty(t.shape[1], dtype=t.dtype), variant, stable)
