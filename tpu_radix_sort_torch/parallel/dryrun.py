"""A dry run of the whole distributed layer at tiny shapes.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``: the
twelve checks its multi-chip record lists, each against the port's numpy
golden (``models/golden.py``), at 256 elements a shard with keys mod 97, so
that a stability fault (equal keys permuted across ranks) shows. It runs
inside an initialised ``torch.distributed`` world: every rank calls
:func:`dryrun_multichip`, makes the same global inputs from one seed,
takes its shard and checks its shard of each result; rank 0 prints one
line a check. The non-power-of-two check runs the exchange at D = 3 on the
first three ranks (the JAX run used D = 6 of 8).
"""
from __future__ import annotations

import time

import numpy as np
import torch.distributed as dist

from ..models.golden import golden_prefix_sum, golden_sort
from ..utils import interop

SHARD = 256


def mesh_over(ranks):
    """A one-dim DeviceMesh named "x" over the world ranks `ranks`, of the
    device type its collectives' tensors live on (the host for gloo, which
    ``comm.py`` hands host copies); every world rank must call this, and
    the ranks outside get None."""
    from torch.distributed.device_mesh import DeviceMesh

    group = dist.new_group(list(ranks))
    if dist.get_rank() not in ranks:
        return None
    device_type = "cpu" if dist.get_backend(group) == "gloo" else "cuda"
    return DeviceMesh.from_group(group, device_type, mesh_dim_names=("x",))


class _Checker:
    def __init__(self, mesh, device):
        self.mesh, self.device = mesh, device
        self.t0 = time.perf_counter()

    def shard(self, x):
        from .mesh_sort import sharded

        return sharded(self.mesh, "x", x, device=self.device)

    def same(self, got, want, what):
        """`got`: this rank's shard (a tensor or a tuple of them); `want`:
        the global numpy result(s)."""
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            w = np.ascontiguousarray(self.shard(w).cpu().numpy())
            g = interop.to_numpy(g)
            if g.dtype != w.dtype or not np.array_equal(g.view(np.uint8), w.view(np.uint8)):
                raise RuntimeError(f"dryrun: {what} differs from the golden on rank "
                                   f"{dist.get_rank()}")

    def mark(self, what):
        if dist.get_rank() == 0:
            print(f"dryrun [{time.perf_counter() - self.t0:6.1f}s] {what}", flush=True)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the twelve checks over the world's first `n_devices` ranks (the
    world must hold at least that many). `device`: where each rank's shards
    live (default: the CUDA card)."""
    import tpu_radix_sort_torch as trt

    from .mesh_sort import mesh_sort
    from .radix_exchange import exchange_sort

    if not dist.is_initialized() or dist.get_world_size() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs an initialised "
                           f"torch.distributed world of at least {n_devices} ranks")
    dev = interop.resolve_device(device)
    mesh = mesh_over(range(n_devices))
    mesh3 = mesh_over(range(3)) if n_devices >= 3 else None
    if mesh is None:
        return
    c = _Checker(mesh, dev)
    n = SHARD * n_devices
    rng = np.random.default_rng(1)
    keys = (rng.integers(0, 2**32, n, dtype=np.uint64) % 97).astype(np.uint32)
    values = np.arange(n, dtype=np.uint32)
    ref = golden_sort(keys, values)
    k, v = c.shard(keys), c.shard(values)

    for method in ("mesh", "exchange"):
        c.same(trt.sort(k, v, mesh=mesh, method=method), ref, f"{method} sort")
        c.mark(f"{method}_sort golden + stability ok")
        if method == "exchange":
            # sorted input: each rank's block goes whole to itself, past its
            # slot, so phase 4 sorts the contiguous chunks again
            c.same(trt.sort(c.shard(ref[0]), c.shard(ref[1]), mesh=mesh, method=method),
                   ref, "exchange phase-4 fallback")
            c.mark("exchange_sort phase-4 fallback ok")

    zk = np.random.default_rng(5).zipf(1.3, size=n).astype(np.uint32)
    c.same(exchange_sort(c.shard(zk), v, mesh=mesh), golden_sort(zk, values), "Zipf skew")
    c.mark("exchange_sort Zipf skew ok")

    if mesh3 is not None:
        c3 = _Checker(mesh3, dev)
        n3 = SHARD * 3
        k3 = (np.random.default_rng(3).integers(0, 2**32, n3, dtype=np.uint64)
              % 97).astype(np.uint32)
        v3 = np.arange(n3, dtype=np.uint32)
        c3.same(exchange_sort(c3.shard(k3), c3.shard(v3), mesh=mesh3),
                golden_sort(k3, v3), "D = 3")
    if n_devices >= 3:
        c.mark("exchange_sort D=3 non-pow2 ok")

    c.same(mesh_sort(k, v, mesh=mesh, overlap_chunks=2), ref, "overlapped exchange")
    c.mark("overlapped exchange ok")

    c.same(mesh_sort(c.shard(ref[0]), c.shard(ref[1]), mesh=mesh, check_order=True),
           ref, "check_order gate")
    c.same(mesh_sort(k, v, mesh=mesh, check_order=True), ref, "check_order gated sort")
    c.mark("distributed check_order gate ok")

    k64 = np.random.default_rng(11).integers(0, 2**64, n, dtype=np.uint64)
    # shared hi words: the lexicographic chain and stability both load
    k64[:n // 2] = (k64[:n // 2] & np.uint64(0xFFFF)) | (np.uint64(7) << np.uint64(32))
    ref64 = golden_sort(k64, values)
    for method in ("mesh", "exchange"):
        c.same(trt.sort(c.shard(k64), v, mesh=mesh, method=method), ref64, f"u64 {method}")
        c.mark(f"u64 {method} (hi,lo,idx) golden + stability ok")

    xs = np.random.default_rng(5).integers(0, 100, n).astype(np.uint32)
    c.same(trt.prefix_sum(c.shard(xs), mesh=mesh), golden_prefix_sum(xs), "mesh prefix_sum")
    c.mark("mesh prefix_sum ok")

    offs = np.linspace(0, n, 8).astype(np.int64)
    offs[2] = offs[1]  # one empty segment
    seg = np.repeat(np.arange(7), np.diff(offs))
    perm = np.lexsort((np.arange(n), zk, seg))
    c.same(trt.sort_segments(c.shard(zk), offs, v, mesh=mesh, device=dev),
           (zk[perm], values[perm]), "mesh sort_segments")
    c.mark("mesh sort_segments golden + stability ok")

    kb = (np.random.default_rng(9).integers(0, 2**32, (n_devices * 2, 128), dtype=np.uint64)
          % 97).astype(np.uint32)
    c.same(trt.sort_batched(c.shard(kb), mesh=mesh), np.sort(kb, axis=1), "mesh sort_batched")
    c.mark("mesh sort_batched ok")
    c.mark("done")
