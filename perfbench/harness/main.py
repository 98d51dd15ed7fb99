"""The benchmark's command: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It reads the cell from ``BENCHMARK.json`` and each of its parts from its
own file (``harness/registry.py``), runs set-up, the window and the check,
and prints the result as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each number of the check beside its
limit, which also end standard error. A cell on several chips runs one
process a card. The run fails, and prints no result, where the cell's cards
are missing or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import socket
import sys
import traceback

import time

import torch

from . import registry
from .cell import CHECK_LIMITS, Plan, entry_module, run_rank

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_radix_sort")
CACHE_DIR = ".perfbench_cache"  # under the checkout: every build and kernel cache
TORCH_IMPORTED = time.perf_counter()


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: profile the window and report the per-layer metrics")
    return p


def make_plan(args, t0: float, root=registry.ROOT) -> Plan:
    bench = registry.benchmark(root)
    cell = registry.cell(bench, args.workload)
    with open(registry.BENCH_DIR / "peaks.json") as f:
        peaks = json.load(f)
    return Plan(cell=cell, config=registry.config(bench, cell["config"], root),
                traffic=registry.traffic(cell["traffic"]),
                metrics=registry.cell_metrics(bench, cell["name"], bool(args.trace)),
                seed=args.seed, seconds=args.seconds, trace=bool(args.trace), t0=t0,
                peaks=peaks)


def set_cache_dirs(root) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = os.path.join(root, CACHE_DIR)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def build(plan: Plan) -> None:
    """Compile the sources the cell's entry names, in parallel, before any
    rank starts; a later run finds them built (the program keeps its builds
    under its own folder in the checkout)."""
    from tpu_radix_sort_torch import _build

    _build.build(list(getattr(entry_module(plan), "SOURCES", ())))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(plan, rank, world, port, results):
    try:
        out = run_rank(plan, rank, world, port)
        out["forbidden"] = forbidden_modules()
        results.put((rank, out))
    except BaseException:
        results.put((rank, {"crash": traceback.format_exc()}))
        raise


def _spawn(plan: Plan, world: int) -> list[dict]:
    """Run the ranks, one process each, and wait for every one to end."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(plan, r, world, port, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < world:
            try:
                rank, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank's process ended with code {dead[0]}")
                continue
            if "crash" in out:
                raise RuntimeError(f"rank {rank} failed:\n{out['crash']}")
            got[rank] = out
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def _combine(values, how: str):
    if how == "max":
        return max(values)
    if how == "min":
        return min(values)
    return sum(values) / len(values)


def execute(plan: Plan) -> dict:
    """One run of the cell; the result as printed."""
    world = int(plan.cell["chips"])
    marks = [("torch imported", TORCH_IMPORTED - plan.t0)]
    if plan.device_type == "cuda":
        build(plan)
        marks.append(("sources built", time.perf_counter() - plan.t0))
    if world == 1:
        ranks = [run_rank(plan)]
        ranks[0]["forbidden"] = forbidden_modules()
    else:
        ranks = _spawn(plan, world)
    metrics = {}
    for m in plan.metrics:
        values = [r["readings"][m["name"]] for r in ranks
                  if r["readings"][m["name"]] is not None]
        if values:
            reader = registry.metric(m["name"], plan.bench_dir)
            metrics[m["name"]] = {"value": _combine(values, getattr(reader, "COMBINE", "mean")),
                                  "unit": m["unit"]}
    reference = registry.module("reference", plan.config["kind"], plan.bench_dir)
    limits = {**reference.LIMITS, **CHECK_LIMITS}
    compared = ranks[0]["compared"]
    failed = max(r["failed"] for r in ranks)
    cuda = plan.device_type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu", "kind": ranks[0]["kind"], "count": world,
              "memory_peak_bytes": max(r["mem_peak"] for r in ranks) if cuda else 0}
    result = {"correct": failed == 0 and all(v <= limits[k] for k, v in compared.items()),
              "attempted": ranks[0]["calls"], "failed": failed, "metrics": metrics,
              "device": device}
    if plan.trace:
        device["busy_s"] = sum(r["busy_s"] for r in ranks) / world
        device["window_s"] = sum(r["window_s"] for r in ranks) / world
        result["breakdown"] = {"device_ops": ranks[0]["device_ops"],
                               "idle_gaps": ranks[0]["idle_gaps"]}
    result["errors"] = [r["error"] for r in ranks if r["error"]]
    result["setup_marks"] = marks + ranks[0]["marks"]
    result["forbidden"] = sorted({n for r in ranks for n in r["forbidden"]})
    result["compared"] = {k: {"value": v, "limit": limits[k]} for k, v in compared.items()}
    return result


def cli(argv, t0: float) -> int:
    args = parser().parse_args(argv)
    plan = make_plan(args, t0)
    chips = int(plan.cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"perfbench: cell {plan.cell['name']} needs {chips} CUDA card(s), "
              f"found {found}", file=sys.stderr)
        return 2
    set_cache_dirs(registry.ROOT)
    result = execute(plan)
    bad = sorted(set(result.pop("forbidden")) | set(forbidden_modules()))
    if bad:
        print(f"perfbench: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print("perfbench: set-up " + ", ".join(f"{name} at {t:.3f} s"
                                           for name, t in result.pop("setup_marks")),
          file=sys.stderr)
    for err in result.pop("errors"):
        print(f"perfbench: a call failed: {err}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
