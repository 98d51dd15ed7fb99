"""Demo: the distributed sorts over a spawned world of ranks.

Counterpart of ``examples/demo_mesh.py``, which runs both exchange
strategies over a ``jax.sharding.Mesh`` of virtual CPU devices. Here
``--devices`` ranks are spawned with ``torch.multiprocessing``; each joins
a ``torch.distributed`` group, builds a one-dim ``DeviceMesh`` named "x",
takes its shard of the seeded keys and runs the strategies
(``parallel/``); rank 0 gathers the shards and holds the result against
the port's golden model.

Usage:
    python -m tpu_radix_sort_torch.examples.demo_mesh --devices 4 --n 4194304 --values --scan
    python -m tpu_radix_sort_torch.examples.demo_mesh --devices 4 --strategy exchange --skew
    python -m tpu_radix_sort_torch.examples.demo_mesh --devices 4 --device cpu

NCCL needs one card a rank. With fewer cards than ``--devices`` every rank
runs gloo on ``cuda:0`` (its collectives cross through the host, and the
ranks share the card: not multi-GPU times); the first line printed names
the backend, each rank's device and the number of cards.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch

GROUP_TIMEOUT_S = 600  # a stuck collective fails its rank
JOIN_TIMEOUT_S = 900


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--devices", type=int, default=8, help="ranks of the mesh")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--values", action="store_true", help="key+value records")
    p.add_argument("--strategy", default="both", choices=["mesh", "exchange", "both"],
                   help="mesh = bitonic compare-split network; exchange = exact-splitter "
                        "single ragged all-to-all")
    p.add_argument("--skew", action="store_true",
                   help="Zipf(1.3)-skewed keys (rank splitting stays balanced)")
    p.add_argument("--overlap", type=int, default=1,
                   help="mesh strategy: exchange pipelined in this many sub-chunks")
    p.add_argument("--descending", action="store_true")
    p.add_argument("--scan", action="store_true",
                   help="also run the distributed prefix sum and order checks "
                        "(prefix_sum/is_sorted/disorder_count with mesh=)")
    p.add_argument("--dtype", default="uint32", choices=["uint32", "uint64"],
                   help="key dtype; uint64 runs (hi, lo, idx) column tuples through "
                        "either strategy")
    p.add_argument("--device", default=None,
                   help="'cuda' (default) or 'cpu': where the ranks' tensors live")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl with a card a rank, else gloo")
    p.add_argument("--seed", type=int, default=0)
    return p


def make_inputs(args):
    """The seeded keys (and values), as the JAX demo makes them."""
    wide = args.dtype == "uint64"
    rng = np.random.default_rng(args.seed)
    if args.skew:
        keys = rng.zipf(1.3, size=args.n).astype(np.uint64 if wide else np.uint32)
    elif wide:
        keys = rng.integers(0, 2**64, args.n, dtype=np.uint64)
    else:
        keys = rng.integers(0, 2**32, args.n, dtype=np.uint64).astype(np.uint32)
    return keys, (np.arange(args.n, dtype=np.uint32) if args.values else None)


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


def _rank(rank, opts, backend, devices, tmp):
    """One rank: its shard of every case; rank 0 gathers and checks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import tpu_radix_sort_torch as trt
    from tpu_radix_sort_torch import _build
    from tpu_radix_sort_torch.models.golden import golden_prefix_sum, golden_sort
    from tpu_radix_sort_torch.parallel import sharded
    from tpu_radix_sort_torch.utils import interop

    args = argparse.Namespace(**opts)
    world = args.devices
    dev = torch.device(devices[rank])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'init')}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", (world,),
                            mesh_dim_names=("x",))
    keys_np, values_np = make_inputs(args)
    keys = sharded(mesh, "x", keys_np, device=dev)
    values = sharded(mesh, "x", values_np, device=dev) if args.values else None
    rows, outputs, launches = [], {}, {k.name: 0 for k in _build.KERNELS}

    def run(name, fn, want):
        """Time fn() on every rank, gather its shards on rank 0 and hold
        them against `want` (a numpy array, a tuple of them, or a value)."""
        dist.barrier()
        if cuda:
            torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, c in _build.launch_counts().items():
            launches[k] += c
        if isinstance(out, torch.Tensor) and out.dim() > 0:
            out = (out,)
        shard = (tuple(interop.to_numpy(o) for o in out) if isinstance(out, tuple)
                 else out.item() if isinstance(out, torch.Tensor) else out)
        gathered = [None] * world if rank == 0 else None
        dist.gather_object((shard, wall), gathered, dst=0)
        if rank != 0:
            return
        walls = [w for _, w in gathered]
        if isinstance(shard, tuple):
            got = tuple(np.concatenate([g[0][i] for g in gathered]) for i in range(len(shard)))
            exp = want if isinstance(want, tuple) else (want,)
            ok = len(got) == len(exp) and all(_equal(g, w) for g, w in zip(got, exp))
            outputs[name] = got
        else:
            got = [g[0] for g in gathered]
            ok = all(g == want for g in got)
            outputs[name] = got[0]
        rows.append({"case": name, "golden_exact": bool(ok), "wall_s": max(walls)})
        print(f"  {name:34s} {max(walls):8.3f}s  golden-exact={ok}", flush=True)

    strategies = []
    if args.strategy in ("mesh", "both"):
        strategies.append(("mesh_sort (compare-split)", lambda k, v: trt.mesh_sort(
            k, v, mesh=mesh, descending=args.descending, overlap_chunks=args.overlap)))
    if args.strategy in ("exchange", "both"):
        strategies.append(("exchange_sort (exact splitters)", lambda k, v: trt.exchange_sort(
            k, v, mesh=mesh, descending=args.descending)))
    want = None
    if rank == 0:
        want = (golden_sort(keys_np, values_np, descending=args.descending) if args.values
                else golden_sort(keys_np, descending=args.descending))
    for name, fn in strategies:
        run(name, lambda fn=fn: fn(keys, values), want)
    if args.scan:
        small = (keys_np % 100).astype(np.uint32)
        xs = sharded(mesh, "x", small, device=dev)
        run("prefix_sum (mesh)", lambda: trt.prefix_sum(xs, mesh=mesh),
            golden_prefix_sum(small) if rank == 0 else None)
        run("disorder_count (mesh)", lambda: trt.disorder_count(keys, mesh=mesh),
            int(np.sum(keys_np[:-1] > keys_np[1:])) if rank == 0 else None)
        srt = sharded(mesh, "x", np.sort(keys_np), device=dev)
        run("is_sorted of sorted input (mesh)", lambda: trt.is_sorted(srt, mesh=mesh), True)
    every = [None] * world if rank == 0 else None
    dist.gather_object(launches, every, dst=0)
    if rank == 0:
        total = {k: sum(c[k] for c in every) for k in launches}
        np.savez(os.path.join(tmp, "outputs.npz"), **{
            f"{name}|{i}": a for name, out in outputs.items()
            for i, a in enumerate(out if isinstance(out, tuple) else (np.asarray(out),))})
        with open(os.path.join(tmp, "result.json"), "w") as f:
            json.dump({"rows": rows, "launches": total,
                       "tuples": [n for n, o in outputs.items() if isinstance(o, tuple)]}, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> dict:
    """Spawn the world, print its table, and return rank 0's result:
    ``rows`` (each case's wall seconds and verdict), ``outputs`` (each
    case's gathered result: a tuple of numpy arrays, or a value),
    ``launches`` (the port's kernel launches summed over the ranks),
    ``backend``, ``rank_devices`` and ``cards``."""
    import torch.multiprocessing as mp

    from tpu_radix_sort_torch.utils import interop

    p = parser()
    args = p.parse_args(argv)
    if args.devices < 1:
        p.error("--devices must be at least 1")
    dev = interop.resolve_device(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = args.backend or ("nccl" if cards >= args.devices else "gloo")
    if backend == "nccl" and cards < args.devices:
        p.error(f"nccl needs one card a rank: {cards} card(s) for {args.devices} ranks")
    if dev.type == "cuda":
        devices = [f"cuda:{r if cards >= args.devices else 0}" for r in range(args.devices)]
    else:
        devices = ["cpu"] * args.devices
    shared = "" if len(set(devices)) == len(devices) or dev.type == "cpu" else (
        "; the ranks share one card: not multi-GPU times")
    print(f"mesh: {args.devices} ranks, backend {backend}, rank devices {devices}, "
          f"{cards} CUDA card(s){shared}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank, args=(vars(args), backend, devices, tmp),
                                 nprocs=args.devices, join=False, start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.terminate()
                raise RuntimeError(f"the world did not end in {JOIN_TIMEOUT_S} s")
        with open(os.path.join(tmp, "result.json")) as f:
            res = json.load(f)
        with np.load(os.path.join(tmp, "outputs.npz")) as z:
            arrays = {k: z[k] for k in z.files}
    outputs = {}
    for key in sorted(arrays, key=lambda k: (k.split("|")[0], int(k.split("|")[1]))):
        name = key.split("|")[0]
        outputs.setdefault(name, []).append(arrays[key])
    outputs = {name: tuple(a) if name in res["tuples"] else a[0].item()
               for name, a in outputs.items()}
    return {"backend": backend, "rank_devices": devices, "cards": cards,
            "rows": res["rows"], "outputs": outputs, "launches": res["launches"]}


if __name__ == "__main__":
    out = main()
    if not all(r["golden_exact"] for r in out["rows"]):
        raise SystemExit("a result differs from the golden model")
