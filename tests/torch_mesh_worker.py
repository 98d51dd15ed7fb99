"""A spawned world of gloo ranks that runs the port's mesh cases on the CPU.

The test files ``tests/test_torch_mesh_*.py`` each start one world
(:func:`start`) of four ranks, joined through a ``file://`` store under
pytest's temporary directory, so that parallel test workers never share a
port. Every rank builds one-dim meshes named "x" over its first 1, 2, 3 and
4 ranks, runs every case of the file's suite whose mesh it is in, and
writes its results to ``rank<r>.npz``; the parent assembles each case's
result (shards concatenated in rank order, or one value that every rank
must agree on) and computes every expected value itself.

This module imports only torch, numpy and the port: the children import no
JAX, and each records whether one crept in. The inputs are functions of
their seeds, so the parent calls the same functions to make them.
"""
from __future__ import annotations

import importlib
import os
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import tpu_radix_sort_torch as trt
from tpu_radix_sort_torch import parallel
from tpu_radix_sort_torch.ops import bitonic
from tpu_radix_sort_torch.parallel import radix_exchange
from tpu_radix_sort_torch.parallel.dryrun import mesh_over
from tpu_radix_sort_torch.utils import interop

# the package's `mesh_sort` attribute is the function; this is the module
mesh_sort_mod = importlib.import_module("tpu_radix_sort_torch.parallel.mesh_sort")

WORLD = 4
# the process group's timeout: a rank that raises fails its test instead of
# leaving the others waiting in a collective
GROUP_TIMEOUT_S = 120
JOIN_TIMEOUT_S = 240

SUITES: dict[str, list] = {}


def case(suite, name, n_dev):
    """Register `fn(mesh)` as case `name` of `suite`, run on the first
    `n_dev` ranks. It returns this rank's result: a tensor or numpy array
    (its shard), a tuple of them, or a bool, int or str that every rank
    returns alike."""
    def deco(fn):
        SUITES.setdefault(suite, []).append((name, n_dev, fn))
        return fn
    return deco


# ---- inputs (the parent makes the same ones) ------------------------------

def u32(seed, n, hi=2**32):
    return np.random.default_rng(seed).integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


def iota(n):
    return np.arange(n, dtype=np.uint32)


def u64_hi_dups(seed, n):
    """u64 keys, half of them under one hi word: lo decides there."""
    k = np.random.default_rng(seed).integers(0, 2**64, n, dtype=np.uint64)
    k[: n // 2] = (k[: n // 2] & np.uint64(0xFFFF)) | (np.uint64(7) << np.uint64(32))
    return k


def neg_floats(seed, n):
    f = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    f[::37] = np.nan
    f[::41] = -0.0
    f[::43] = -np.inf
    f[::47] = np.inf
    return f


def zipf(seed, n, a=1.3):
    return np.random.default_rng(seed).zipf(a, n).astype(np.uint32)


def layout_keys(seed, n, wide=False):
    """Keys for the layout test: real all-ones keys on every part of the
    array, many duplicates under the mask (low 8 bits drawn from 4 values)."""
    rng = np.random.default_rng(seed)
    if wide:
        k = rng.integers(0, 2**64, n, dtype=np.uint64)
        k = (k & ~np.uint64(0xFF)) | rng.integers(0, 4, n).astype(np.uint64)
        k[::7] = np.uint64(2**64 - 1)
        return k
    k = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    k = (k & np.uint32(0xFFFFFF00)) | rng.integers(0, 4, n).astype(np.uint32)
    k[::7] = np.uint32(0xFFFFFFFF)
    return k


def segments(seed, n, S, empty=True):
    """CSR offsets of S segments over n elements, some empty."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, n + 1, S - 1))
    offs = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    if empty and S > 3:
        offs[2] = offs[1]
        offs[-2] = n  # a trailing empty segment
    return offs


# ---- helpers of the cases ---------------------------------------------------

def sh(mesh, x):
    """This rank's even shard (``torch.tensor_split``) of x, on the CPU."""
    return parallel.sharded(mesh, "x", x, device="cpu")


def part(mesh, x, lengths):
    """This rank's shard of x cut at the given shard lengths."""
    me = mesh.get_local_rank("x")
    lo = sum(lengths[:me])
    return interop.as_tensor(np.ascontiguousarray(x[lo:lo + lengths[me]]), "cpu")


def raises(fn):
    """The name of the exception `fn` raises, or "" when it returns."""
    try:
        fn()
    except (TypeError, ValueError) as e:
        return type(e).__name__
    return ""


class Count:
    """Counts the calls of module attributes while it is open."""

    def __init__(self, *targets):
        self.targets = targets
        self.calls = {name: 0 for _, name in targets}

    def __enter__(self):
        self.saved = []
        for mod, name in self.targets:
            orig = getattr(mod, name)

            def counted(*a, _orig=orig, _name=name, **kw):
                self.calls[_name] += 1
                return _orig(*a, **kw)
            self.saved.append((mod, name, orig))
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved:
            setattr(mod, name, orig)
        return False


# ---- the world ----------------------------------------------------------------

def _flat(out):
    if isinstance(out, tuple):
        return [t for o in out for t in _flat(o)]
    return [out]


def _store(results, name, out):
    """A case's result into `results`; nested tuples are flattened."""
    if isinstance(out, (bool, int, str)):
        results[f"{name}|s|0"] = np.array(out)
        return
    for i, t in enumerate(_flat(out)):
        results[f"{name}|a|{i}"] = t if isinstance(t, np.ndarray) else interop.to_numpy(t)


def _rank_main(rank, world, init, out_dir, suite):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    meshes = {d: mesh_over(range(d)) for d in range(1, world + 1)}
    results = {}
    for name, n_dev, fn in SUITES[suite]:
        if meshes[n_dev] is not None:
            _store(results, name, fn(meshes[n_dev]))
    results["_jax_imported|s|0"] = np.array("jax" in sys.modules)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
    dist.barrier()
    dist.destroy_process_group()


class World:
    """A started world; :meth:`__getitem__` waits for it once."""

    def __init__(self, ctx, out_dir, suite):
        self.ctx, self.out_dir, self.suite = ctx, out_dir, suite
        self.results = None
        self.error = None

    def _join(self):
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while not self.ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in self.ctx.processes:
                    p.terminate()
                raise TimeoutError(f"the mesh world of suite {self.suite!r} did not end "
                                   f"in {JOIN_TIMEOUT_S} s")
        ranks = [dict(np.load(os.path.join(self.out_dir, f"rank{r}.npz")))
                 for r in range(WORLD)]
        self.results = {}
        names = {k.split("|")[0] for r in ranks for k in r}
        for name in names:
            per_rank = [{k: v for k, v in r.items() if k.split("|")[0] == name}
                        for r in ranks]
            per_rank = [r for r in per_rank if r]
            keys = sorted(per_rank[0], key=lambda k: int(k.split("|")[2]))
            if keys[0].split("|")[1] == "s":
                vals = [r[keys[0]].item() for r in per_rank]
                self.results[name] = vals[0] if len(set(vals)) == 1 else ("ranks differ", vals)
            else:
                arrs = tuple(np.concatenate([r[k] for r in per_rank]) for k in keys)
                self.results[name] = arrs[0] if len(arrs) == 1 else arrs

    def __getitem__(self, name):
        if self.error is not None:
            raise RuntimeError(f"the mesh world of suite {self.suite!r} failed") from self.error
        if self.results is None:
            try:
                self._join()
            except Exception as e:  # every later case reports the same failure
                self.error = e
                raise
        return self.results[name]


def start(suite, tmp_dir) -> World:
    """Start the world of `suite` (WORLD spawned gloo ranks); results are
    read, waiting once, through the returned :class:`World`."""
    tmp_dir = str(tmp_dir)
    ctx = mp.start_processes(_rank_main, args=(WORLD, os.path.join(tmp_dir, "init"), tmp_dir,
                                               suite),
                             nprocs=WORLD, join=False, start_method="spawn")
    return World(ctx, tmp_dir, suite)



# ---- suite "sort": mesh_sort and sort(mesh=) ---------------------------------

@case("sort", "keys_d1", 1)
def _(mesh):
    return trt.mesh_sort(sh(mesh, u32(1, 256)), mesh=mesh)


@case("sort", "keys_d2", 2)
def _(mesh):
    return trt.mesh_sort(sh(mesh, u32(2, 1000)), mesh=mesh)


@case("sort", "keys_d4", 4)
def _(mesh):
    return trt.mesh_sort(sh(mesh, u32(3, 4096)), mesh=mesh)


for _d in (2, 4):
    @case("sort", f"kv_count_d{_d}", _d)
    def _(mesh):
        k, v = u32(4, 3000, 2**10), iota(3000)
        return trt.mesh_sort(sh(mesh, k), sh(mesh, v), mesh=mesh, count=2222)


@case("sort", "bit_count_kv", 4)
def _(mesh):
    return trt.mesh_sort(sh(mesh, u32(5, 3000)), sh(mesh, iota(3000)), mesh=mesh, bit_count=8)


@case("sort", "float_keys", 4)
def _(mesh):
    f = np.random.default_rng(6).random(2048, dtype=np.float32) * 100
    return trt.mesh_sort(sh(mesh, f), mesh=mesh)


@case("sort", "descending_kv", 4)
def _(mesh):
    return trt.mesh_sort(sh(mesh, u32(7, 1000, 2**8)), sh(mesh, iota(1000)), mesh=mesh,
                         descending=True)


@case("sort", "total_order_kv", 4)
def _(mesh):
    return trt.mesh_sort(sh(mesh, neg_floats(8, 1500)), sh(mesh, iota(1500)), mesh=mesh,
                         total_order=True)


@case("sort", "f16_total_order", 2)
def _(mesh):
    f = neg_floats(9, 700).astype(np.float16)
    return trt.mesh_sort(sh(mesh, f), sh(mesh, iota(700)), mesh=mesh, total_order=True)


@case("sort", "i16_bit_count_desc", 4)
def _(mesh):
    k = np.random.default_rng(10).integers(-2**15, 2**15, 900).astype(np.int16)
    return trt.mesh_sort(sh(mesh, k), mesh=mesh, bit_count=12, descending=True)


for _s in (2, 4):
    @case("sort", f"overlap_{_s}", 4)
    def _(mesh, _s=_s):
        k, v = u32(11, 6000, 2**8), iota(6000)
        return trt.mesh_sort(sh(mesh, k), sh(mesh, v), mesh=mesh, count=5000,
                             overlap_chunks=_s)


@case("sort", "overlap_validation", 4)
def _(mesh):
    # the padded block is 1,024 here; 7 does not divide it
    return raises(lambda: trt.mesh_sort(sh(mesh, u32(12, 4096)), mesh=mesh, overlap_chunks=7))


@case("sort", "check_order_sorted", 4)
def _(mesh):
    k, v = u32(13, 3000, 2**9), iota(3000)
    order = np.argsort(k, kind="stable")
    with Count((bitonic, "run_schedule")) as c:
        out = trt.mesh_sort(sh(mesh, k[order]), sh(mesh, v[order]), mesh=mesh,
                            check_order=True)
    return (*out, np.array([c.calls["run_schedule"]]))


@case("sort", "check_order_unsorted", 4)
def _(mesh):
    k, v = u32(13, 3000, 2**9), iota(3000)
    with Count((bitonic, "run_schedule")) as c:
        out = trt.mesh_sort(sh(mesh, k), sh(mesh, v), mesh=mesh, check_order=True)
    return (*out, np.array([c.calls["run_schedule"]]))


@case("sort", "check_order_boundary_only", 4)
def _(mesh):
    # every shard sorted, the shards out of order: only the edges show it
    k = np.concatenate([np.sort(u32(14 + i, 512)) for i in range(4)])[::-1].copy()
    k = np.concatenate([np.sort(c) for c in np.array_split(k, 4)])
    return trt.mesh_sort(sh(mesh, k), mesh=mesh, check_order=True)


for _m in ("auto", "mesh", "exchange"):
    @case("sort", f"routed_{_m}", 4)
    def _(mesh, _m=_m):
        k, v = u32(15, 2500, 2**9), iota(2500)
        with Count((mesh_sort_mod, "_shard_sort"), (radix_exchange, "_shard_exchange_sort")) as c:
            out = trt.sort(sh(mesh, k), sh(mesh, v), mesh=mesh, method=_m,
                           values_are_ranks=True)
        return (*out, np.array([c.calls["_shard_sort"], c.calls["_shard_exchange_sort"]]))


@case("sort", "routed_bad_method", 4)
def _(mesh):
    return raises(lambda: trt.sort(sh(mesh, u32(16, 64)), mesh=mesh, method="bitonic"))


@case("sort", "argsort_uneven", 4)
def _(mesh):
    k = u32(17, 1000, 2**7)
    return trt.argsort(part(mesh, k, [100, 0, 650, 250]), mesh=mesh)


@case("sort", "sort_packed", 2)
def _(mesh):
    p = np.stack([u32(18, 600, 2**8), iota(600)], axis=1)
    return trt.sort_packed(sh(mesh, p), mesh=mesh)


@case("sort", "u64_kv", 4)
def _(mesh):
    return trt.mesh_sort(sh(mesh, u64_hi_dups(19, 2048)), sh(mesh, iota(2048)), mesh=mesh)


@case("sort", "u64_bit_count_40_desc", 4)
def _(mesh):
    return trt.mesh_sort(sh(mesh, u64_hi_dups(20, 2048)), mesh=mesh, bit_count=40,
                         descending=True)


@case("sort", "u64_bit_count_16_count", 4)
def _(mesh):
    k, v = u64_hi_dups(21, 2048), np.arange(2048, dtype=np.uint64) * np.uint64(3**30)
    return trt.mesh_sort(sh(mesh, k), sh(mesh, v), mesh=mesh, bit_count=16, count=1999)


@case("sort", "i64_f64_total_order", 4)
def _(mesh):
    rng = np.random.default_rng(22)
    i = rng.integers(-(2**62), 2**62, 1024).astype(np.int64)
    f = rng.standard_normal(1024)
    return (trt.mesh_sort(sh(mesh, i), mesh=mesh, total_order=True),
            trt.mesh_sort(sh(mesh, f), mesh=mesh, total_order=True))


@case("sort", "kernel_class", 4)
def _(mesh):
    k, v = u32(23, 2000, 2**8), iota(2000)
    kern = trt.RadixSortKernel(count=1500, has_values=True, mesh=mesh, axis_name="x",
                               device="cpu")
    kern.compile(2000)
    return kern.dispatch(sh(mesh, k), sh(mesh, v))


@case("sort", "jax_d2", 2)
def _(mesh):
    k, v = u32(24, 512, 2**6), iota(512)
    return trt.mesh_sort(sh(mesh, k), sh(mesh, v), mesh=mesh, count=500)


# ---- suite "exchange": exchange_sort ------------------------------------------

def _phase4(fn):
    """Run fn counting phase 4's two branches: (slotted merge-tree calls,
    contiguous re-sorts); the local sort is one more sort_padded_cols."""
    with Count((bitonic, "merge_tree_padded_cols"), (bitonic, "sort_padded_cols")) as c:
        out = fn()
    calls = np.array([c.calls["merge_tree_padded_cols"], c.calls["sort_padded_cols"] - 1])
    return (*(out if isinstance(out, tuple) else (out,)), calls)


@case("exchange", "keys_d2", 2)
def _(mesh):
    return trt.exchange_sort(sh(mesh, u32(30, 512)), mesh=mesh)


@case("exchange", "keys_d4", 4)
def _(mesh):
    return trt.exchange_sort(sh(mesh, u32(31, 4000)), mesh=mesh)


@case("exchange", "kv_dups", 4)
def _(mesh):
    k = (u32(32, 4096) % np.uint32(97)).astype(np.uint32)
    return _phase4(lambda: trt.exchange_sort(sh(mesh, k), sh(mesh, iota(4096)), mesh=mesh))


@case("exchange", "kv_dups_count", 4)
def _(mesh):
    k = (u32(32, 5000) % np.uint32(97)).astype(np.uint32)
    return _phase4(lambda: trt.exchange_sort(sh(mesh, k), sh(mesh, iota(5000)), mesh=mesh,
                                             count=4321))


@case("exchange", "zipf", 4)
def _(mesh):
    return _phase4(lambda: trt.exchange_sort(sh(mesh, zipf(33, 4096, 1.2)), mesh=mesh))


@case("exchange", "all_equal", 4)
def _(mesh):
    k = np.full(4096, 7, dtype=np.uint32)
    return _phase4(lambda: trt.exchange_sort(sh(mesh, k), sh(mesh, iota(4096)), mesh=mesh))


@case("exchange", "presorted", 4)
def _(mesh):
    k = np.sort(u32(34, 4096, 2**10))
    return _phase4(lambda: trt.exchange_sort(sh(mesh, k), sh(mesh, iota(4096)), mesh=mesh))


@case("exchange", "d3_random", 3)
def _(mesh):
    return _phase4(lambda: trt.exchange_sort(sh(mesh, u32(35, 3 * 512, 2**9)),
                                             sh(mesh, iota(3 * 512)), mesh=mesh))


@case("exchange", "d3_zipf", 3)
def _(mesh):
    return trt.exchange_sort(sh(mesh, zipf(36, 3 * 700)), sh(mesh, iota(3 * 700)), mesh=mesh)


@case("exchange", "bit_count_8_kv", 4)
def _(mesh):
    return trt.exchange_sort(sh(mesh, u32(37, 3000)), sh(mesh, iota(3000)), mesh=mesh,
                             bit_count=8)


@case("exchange", "descending_kv", 4)
def _(mesh):
    return trt.exchange_sort(sh(mesh, u32(38, 2000, 2**8)), sh(mesh, iota(2000)), mesh=mesh,
                             descending=True)


@case("exchange", "total_order_f32", 4)
def _(mesh):
    return trt.exchange_sort(sh(mesh, neg_floats(39, 2000)), sh(mesh, iota(2000)), mesh=mesh,
                             total_order=True)


for _srt in (True, False):
    @case("exchange", f"check_order_{'sorted' if _srt else 'unsorted'}", 4)
    def _(mesh, _srt=_srt):
        k = u32(40, 3000, 2**9)
        k = np.sort(k) if _srt else k
        with Count((bitonic, "run_schedule")) as c:
            out = trt.exchange_sort(sh(mesh, k), mesh=mesh, check_order=True)
        return out, np.array([c.calls["run_schedule"]])


@case("exchange", "u64_kv", 4)
def _(mesh):
    return trt.exchange_sort(sh(mesh, u64_hi_dups(41, 4096)), sh(mesh, iota(4096)), mesh=mesh)


@case("exchange", "u64_count", 4)
def _(mesh):
    return trt.exchange_sort(sh(mesh, u64_hi_dups(41, 4096)), mesh=mesh, count=3000)


@case("exchange", "u64_bit_count_40_desc", 4)
def _(mesh):
    return trt.exchange_sort(sh(mesh, u64_hi_dups(41, 4096)), mesh=mesh, bit_count=40,
                             descending=True)


@case("exchange", "u64_bit_count_16", 4)
def _(mesh):
    return trt.exchange_sort(sh(mesh, u64_hi_dups(41, 4096)), mesh=mesh, bit_count=16)


@case("exchange", "u64_zipf_lo", 4)
def _(mesh):
    k = (np.uint64(3) << np.uint64(32)) | zipf(42, 4096).astype(np.uint64)
    return trt.exchange_sort(sh(mesh, k), sh(mesh, iota(4096)), mesh=mesh)


@case("exchange", "u64_all_equal", 4)
def _(mesh):
    k = np.full(4096, 0x9E3779B97F4A7C15, dtype=np.uint64)
    return trt.exchange_sort(sh(mesh, k), sh(mesh, iota(4096)), mesh=mesh)


@case("exchange", "u64_d3", 3)
def _(mesh):
    return trt.exchange_sort(sh(mesh, u64_hi_dups(43, 3 * 512)), sh(mesh, iota(3 * 512)),
                             mesh=mesh)


@case("exchange", "f64_i64_total_order", 4)
def _(mesh):
    rng = np.random.default_rng(44)
    f = rng.standard_normal(2048)
    i = rng.integers(-(2**62), 2**62, 2048).astype(np.int64)
    return (trt.exchange_sort(sh(mesh, f), mesh=mesh, total_order=True),
            trt.exchange_sort(sh(mesh, i), mesh=mesh, total_order=True))


@case("exchange", "probe_k8", 4)
def _(mesh):
    # the pod-scale bisection: 2^8 probes a round, four rounds for u32
    saved = radix_exchange._probe_log2
    radix_exchange._probe_log2 = lambda n_dev: 8
    try:
        return (trt.exchange_sort(sh(mesh, u32(45, 4096, 2**12)), sh(mesh, iota(4096)),
                                  mesh=mesh),
                trt.exchange_sort(sh(mesh, u64_hi_dups(46, 2048)), mesh=mesh))
    finally:
        radix_exchange._probe_log2 = saved


def select_splits_input(d=4, L=1024):
    """Sorted u32 key shards (heavy duplicates) for the splitter."""
    k = (u32(47, d * L) % np.uint32(13)).astype(np.uint32)
    k[: L // 2] = 5  # one long tie run across the first boundary too
    return np.concatenate([np.sort(c) for c in np.split(k, d)])


@case("exchange", "select_splits", 4)
def _(mesh):
    k = sh(mesh, select_splits_input()).view(torch.int32)
    L = k.shape[0]
    group = mesh.get_group("x")
    return torch.tensor(radix_exchange._select_splits((k,), [L * d for d in range(1, 4)],
                                                      group), dtype=torch.int32)


def ragged_input(d=4, L=64):
    """(data, starts, sizes, out_offsets, out_buf length) for the ragged
    all-to-all: uneven chunks from uneven starts into gapped offsets."""
    rng = np.random.default_rng(48)
    a = rng.integers(0, 2**32, d * L, dtype=np.uint64).astype(np.uint32)
    sizes = rng.integers(0, 9, (d, d)).astype(np.int32)
    starts = np.zeros((d, d), np.int32)
    for s in range(d):
        starts[s] = np.cumsum(np.concatenate([[3], sizes[s, :-1] + 1]))[:d]
    offs = np.zeros((d, d), np.int32)
    for t in range(d):
        offs[:, t] = np.cumsum(np.concatenate([[1], sizes[:-1, t] + 2]))
    return a, starts, sizes, offs, 48


@case("exchange", "ragged", 4)
def _(mesh):
    a, starts, sizes, offs, b = ragged_input()
    x = sh(mesh, a).view(torch.int32)[None]
    buf = torch.full((1, b), 0x5A5A5A5A, dtype=torch.int32)
    out = radix_exchange.ragged_all_to_all(x, buf, starts.tolist(), sizes.tolist(),
                                           offs.tolist(), mesh.get_group("x"))
    return out[0].view(torch.uint32)


# ---- suite "check_scan": prefix_sum, is_sorted, disorder_count -------------

def scan_items(seed, n, dtype=np.uint32, hi=100):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31, n).astype(np.int32)
    return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32)


@case("check_scan", "scan_d2", 2)
def _(mesh):
    return trt.prefix_sum(sh(mesh, scan_items(50, 1000)), mesh=mesh)


@case("check_scan", "scan_d4_count", 4)
def _(mesh):
    x = scan_items(51, 5000)
    return (trt.prefix_sum(sh(mesh, x), mesh=mesh, count=3333),
            trt.prefix_sum(sh(mesh, x), mesh=mesh, count=3333, inclusive=True))


@case("check_scan", "scan_wrap_int32", 4)
def _(mesh):
    return (trt.prefix_sum(sh(mesh, scan_items(52, 3000, hi=2**32)), mesh=mesh),
            trt.prefix_sum(sh(mesh, scan_items(53, 3000, np.int32)), mesh=mesh, inclusive=True))


@case("check_scan", "scan_uneven", 4)
def _(mesh):
    # an empty shard, and count inside the third shard
    x = scan_items(54, 700, hi=2**32)
    return trt.prefix_sum(part(mesh, x, [300, 0, 250, 150]), mesh=mesh, count=420)


@case("check_scan", "scan_count_0_d3", 3)
def _(mesh):
    return trt.prefix_sum(sh(mesh, scan_items(55, 10)), mesh=mesh, count=0)


@case("check_scan", "scan_kernel_class", 4)
def _(mesh):
    kern = trt.PrefixSumKernel(count=2500, inclusive=True, mesh=mesh, axis_name="x",
                               device="cpu")
    kern.compile(3000)
    return kern.dispatch(sh(mesh, scan_items(56, 3000)))


@case("check_scan", "jax_scan_d2", 2)
def _(mesh):
    return trt.prefix_sum(sh(mesh, scan_items(57, 512, hi=2**32)), mesh=mesh, count=400)


def check_inputs():
    """(name, keys, kwargs) of the order checks: each is checked by
    `is_sorted` and `disorder_count` over the same mesh."""
    rng = np.random.default_rng(58)
    r = u32(59, 5000, 2**12)
    s = np.sort(r)
    f = neg_floats(60, 3000)
    boundary = np.concatenate([np.sort(u32(61 + i, 512)) for i in range(4)])
    k64 = np.sort(u64_hi_dups(65, 2048))
    k64d = k64.copy()
    k64d[[100, 1500]] = k64d[[1500, 100]]
    return [
        ("random", r, {}),
        ("random_count", r, {"count": 1777}),
        ("random_bit_count", r, {"bit_count": 8}),
        ("sorted", s, {}),
        ("sorted_bit_count", s, {"bit_count": 12}),
        ("sorted_desc_false", s, {"descending": True}),
        ("desc", s[::-1].copy(), {"descending": True}),
        ("floats_total_order", np.sort(np.nan_to_num(f)), {"total_order": True}),
        ("floats_raw", np.sort(np.nan_to_num(f)), {}),
        ("boundary_only", boundary, {}),
        ("u64_sorted", k64, {}),
        ("u64_swapped", k64d, {}),
        ("u64_bit_count_40", k64d, {"bit_count": 40}),
        ("u64_bit_count_24", k64d, {"bit_count": 24, "count": 1600}),
        ("i16", rng.integers(-100, 100, 900).astype(np.int16), {"total_order": True}),
    ]


@case("check_scan", "checks_d4", 4)
def _(mesh):
    out = []
    for _, k, kw in check_inputs():
        out.append(np.array([trt.is_sorted(sh(mesh, k), mesh=mesh, **kw),
                             int(trt.disorder_count(sh(mesh, k), mesh=mesh, **kw))]))
    return tuple(out)


@case("check_scan", "checks_uneven_d4", 4)
def _(mesh):
    # shards of 0, 1, 0 and 2 elements, and of 3 with two empty neighbours
    out = []
    for k, lengths in (([5, 3, 4], [0, 1, 0, 2]), ([1, 2, 3], [0, 3, 0, 0]),
                       ([4, 1, 2, 3, 9], [2, 0, 0, 3])):
        k = np.array(k, dtype=np.uint32)
        out.append(np.array([trt.is_sorted(part(mesh, k, lengths), mesh=mesh),
                             int(trt.disorder_count(part(mesh, k, lengths), mesh=mesh))]))
    return tuple(out)


@case("check_scan", "jax_checks_d2", 2)
def _(mesh):
    k = u32(66, 512, 2**8)
    k[:300] = np.sort(k[:300])
    return np.array([trt.is_sorted(sh(mesh, k), mesh=mesh, count=300),
                     trt.is_sorted(sh(mesh, k), mesh=mesh),
                     int(trt.disorder_count(sh(mesh, k), mesh=mesh, count=400)),
                     int(trt.disorder_count(sh(mesh, k), mesh=mesh, bit_count=4))])


# ---- suite "layout": the padded layout, batched and segmented sorts ------

LAYOUT_N, LAYOUT_COUNT = 1000, 997  # count not a multiple of 3 or 4
LAYOUT_SHARDS = {3: [123, 600, 277], 4: [400, 37, 0, 563]}


def layout_variants():
    """(name, keys, values or None, kwargs) of the layout test: real
    all-ones keys (and, descending, zeros) beside the sentinel pads."""
    k = layout_keys(70, LAYOUT_N)
    k[5::11] = 0
    w = layout_keys(71, LAYOUT_N, wide=True)
    v = iota(LAYOUT_N)
    c = LAYOUT_COUNT
    return [
        ("keys", k, None, {"count": c}),
        ("kv", k, v, {"count": c}),
        ("kv_bit_count_8", k, v, {"count": c, "bit_count": 8}),
        ("kv_descending", k, v, {"count": c, "descending": True}),
        ("u64_keys", w, None, {"count": c}),
        ("u64_kv_bit_count_8", w, v, {"count": c, "bit_count": 8}),
    ]


for _meth, _d in (("exchange", 3), ("mesh", 4), ("exchange", 4)):
    for _i, (_name, *_) in enumerate(layout_variants()):
        @case("layout", f"layout_{_meth}_d{_d}_{_name}", _d)
        def _(mesh, _meth=_meth, _d=_d, _i=_i):
            _, k, v, kw = layout_variants()[_i]
            args = [part(mesh, k, LAYOUT_SHARDS[_d])]
            if v is not None:
                args.append(part(mesh, v, LAYOUT_SHARDS[_d]))
            return trt.sort(*args, mesh=mesh, method=_meth, **kw)


@case("layout", "wrong_axis_name", 2)
def _(mesh):
    return raises(lambda: trt.sort(sh(mesh, u32(72, 16)), mesh=mesh, axis_name="y"))


def batched_input(seed, rows, n, dtype=np.uint32):
    if dtype == np.uint64:
        return np.random.default_rng(seed).integers(0, 2**64, (rows, n), dtype=np.uint64)
    return (u32(seed, rows * n) % np.uint32(97)).astype(dtype).reshape(rows, n)


@case("layout", "batched_kv_desc", 4)
def _(mesh):
    k = batched_input(73, 7, 300)
    v = np.tile(iota(300), (7, 1))
    return trt.sort_batched(sh(mesh, k), sh(mesh, v), mesh=mesh, descending=True)


@case("layout", "argsort_batched_empty_rank", 4)
def _(mesh):
    return trt.argsort_batched(sh(mesh, batched_input(74, 3, 500)), mesh=mesh)


@case("layout", "batched_u64_bit_count", 2)
def _(mesh):
    return trt.sort_batched(sh(mesh, batched_input(75, 5, 129, np.uint64)), mesh=mesh,
                            bit_count=40)


def segmented_variants():
    """(name, n_dev, keys, offsets, values or None, kwargs)."""
    rng = np.random.default_rng(76)
    f = rng.standard_normal(1500).astype(np.float32)
    return [
        ("seg_u32", 4, u32(77, 3000, 2**10), segments(78, 3000, 23), iota(3000), {}),
        ("seg_u16_packed", 4, u32(79, 2500, 2**16).astype(np.uint16), segments(80, 2500, 100),
         iota(2500), {}),
        ("seg_u32_bit_count_12_packed", 2, u32(81, 2000), segments(82, 2000, 50), None,
         {"bit_count": 12}),
        ("seg_f32_desc_total_order", 2, f, segments(83, 1500, 9), iota(1500),
         {"descending": True, "total_order": True}),
        ("seg_u64_bit_count_40", 4, u64_hi_dups(84, 2048), segments(85, 2048, 30),
         np.arange(2048, dtype=np.uint64), {"bit_count": 40}),
        ("seg_one_segment", 4, u32(86, 1024, 50), np.array([0, 1024]), iota(1024), {}),
    ]


for _i, (_name, _d, *_) in enumerate(segmented_variants()):
    @case("layout", _name, _d)
    def _(mesh, _i=_i):
        _, _, k, offs, v, kw = segmented_variants()[_i]
        args = (sh(mesh, k), offs) + (() if v is None else (sh(mesh, v),))
        return trt.sort_segments(*args, mesh=mesh, **kw)


@case("layout", "argsort_segments", 4)
def _(mesh):
    return trt.argsort_segments(sh(mesh, u32(87, 3000, 2**6)), segments(88, 3000, 40),
                                mesh=mesh)


@case("layout", "segments_bad_method", 2)
def _(mesh):
    k = sh(mesh, u32(89, 64))
    msgs = []
    for fn in (trt.sort_segments, trt.argsort_segments):
        try:
            fn(k, np.array([0, 64]), mesh=mesh, method="bitonic")
        except ValueError as e:
            msgs.append(str(e))
    return "|".join(msgs)


@case("layout", "dryrun", 4)
def _(mesh):
    from tpu_radix_sort_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    return True
