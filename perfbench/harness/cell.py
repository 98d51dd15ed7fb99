"""One rank of one run of a cell: set-up, the window, the readings, the check.

A one-chip cell runs this in the benchmark's own process; a cell on
several chips runs it in one process a chip (``harness/main.py``), each
rank with its shard of every input, over a ``DeviceMesh`` on NCCL (gloo on
the CPU, where the tests drive it).
"""
from __future__ import annotations

import contextlib
import gc
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from datetime import timedelta

import numpy as np
import torch

from perfbench.reference import mismatches

from . import generate, registry, trace
from .window import closed_loop

# Each slot keeps the answer of one visit among its first KEEP_VISITS,
# drawn from the seed, for the check after the window.
KEEP_VISITS = 8
# A traced window holds at most this many calls, which keeps its trace
# file to some tens of MB.
TRACE_MAX_CALLS = 256
# A cell across cards sizes its window by the time of this many calls.
PACE_CALLS = 2
GROUP_TIMEOUT = timedelta(seconds=300)
# The numbers the harness adds to the reference's own in the check, each
# with its limit: pool slots never called in the window, and input
# positions whose bytes the program changed (the window must time the
# traffic as made, not inputs that an earlier call sorted in place).
CHECK_LIMITS = {"unanswered": 0, "inputs_changed": 0}


@dataclass
class Plan:
    """What one run does: the cell's parts as read from their files."""
    cell: dict
    config: dict
    traffic: dict
    metrics: list
    seed: int
    seconds: float
    trace: bool
    t0: float
    device_type: str = "cuda"
    bench_dir: str = str(registry.BENCH_DIR)
    entry_file: str | None = None       # an entry in place of entries/<kind>.py
    peaks: dict = field(default_factory=dict)


@dataclass
class RankRun:
    """What a metric's reader reads: one rank's window, counters and trace."""
    rank: int
    world: int
    config: dict
    keys_per_call: int          # keys of one call, all ranks together
    bytes_per_call: int         # this rank's input bytes read and output bytes written
    t0: float                   # process start (perf_counter)
    first_call: float
    latencies: list
    enqueue: list
    window_s: float
    calls: int
    launches: int | None        # the program's kernel launches in the window
    mem_base: int | None        # bytes allocated when the window opened
    mem_peak: int | None        # most bytes allocated in the window
    events: list | None = None  # the traced window's trace events
    span: tuple | None = None   # (start, end, thread) of the window in the trace
    peak: dict | None = None    # the card's published peaks (``peaks.json``)


class Env:
    """What an entry may use besides its inputs: the device and the mesh."""

    def __init__(self, rank, world, device, mesh=None):
        self.rank, self.world, self.device, self.mesh = rank, world, device, mesh


def entry_module(plan: Plan):
    if plan.entry_file:
        return registry.module_at(plan.entry_file, "entry")
    return registry.module("entries", plan.config["kind"], plan.bench_dir)


def launch_total() -> int | None:
    """The program's kernel launches so far (its ``_build`` counters)."""
    try:
        from tpu_radix_sort_torch import _build
    except ImportError:
        return None
    counts = getattr(_build, "launch_counts", None)
    return None if counts is None else sum(counts().values())


def call_bytes(inputs: dict, answer: dict) -> int:
    """Bytes a call must move at the least: each input byte read once and
    each output byte written once, from the tensors' shapes."""
    return sum(t.numel() * t.element_size() for t in (*inputs.values(), *answer.values()))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(name):
    return torch.profiler.record_function(name)


def _gather(t: torch.Tensor, world: int) -> torch.Tensor:
    """The shards of `t` on every rank, concatenated in rank order."""
    import torch.distributed as dist

    words = t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)
    parts = [torch.empty_like(words) for _ in range(world)]
    dist.all_gather(parts, words)
    return torch.cat(parts).view(t.dtype)


def run_rank(plan: Plan, rank: int = 0, world: int = 1, port: int | None = None) -> dict:
    cuda = plan.device_type == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    mesh = flags = None
    if world > 1:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        dist.init_process_group("nccl" if cuda else "gloo", rank=rank, world_size=world,
                                init_method=f"tcp://localhost:{port}", timeout=GROUP_TIMEOUT)
        mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("x",))
        # the pacing and barriers go over gloo: no work on the card
        flags = dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)
    try:
        return _run(plan, rank, world, dev, mesh, flags)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def _run(plan, rank, world, dev, mesh, flags):
    import tpu_radix_sort_torch as program

    marks = [("program imported", time.perf_counter())]

    env = Env(rank, world, dev, mesh)
    entry = entry_module(plan)
    reference = registry.module("reference", plan.config["kind"], plan.bench_dir)
    cfg, tr, seed = plan.config, plan.traffic, plan.seed
    pool = []
    for slot in range(generate.pool_size(tr)):
        whole = generate.global_inputs(cfg, tr, seed, slot, dev, plan.bench_dir)
        pool.append(generate.shard(whole, rank, world) if world > 1 else whole)
        del whole
    marks.append(("inputs made", time.perf_counter()))
    keep = np.random.default_rng(generate.sub_seed(seed, "keep")).integers(
        0, KEEP_VISITS, len(pool)).tolist()

    def call(inp):
        return entry.call(program, inp, env)

    # warm-up: one call a slot builds and loads what the path needs and
    # fills the kept answers, so that the memory held stays level in the window
    kept = [call(inp) for inp in pool]
    _sync(dev)
    marks.append(("warmed up", time.perf_counter()))
    bytes_per_call = call_bytes(pool[0], kept[0])

    seconds, max_calls = plan.seconds, TRACE_MAX_CALLS if plan.trace else None
    if world > 1:
        # every rank makes the same calls (each is collective): the window
        # holds the seconds over the slowest rank's time a paced call
        import torch.distributed as dist

        dist.barrier(group=flags)
        t = time.perf_counter()
        for i in range(PACE_CALLS):
            call(pool[i % len(pool)])
            _sync(dev)
        per = torch.tensor([(time.perf_counter() - t) / PACE_CALLS], dtype=torch.float64)
        dist.all_reduce(per, op=dist.ReduceOp.MAX, group=flags)
        max_calls = min(max(1, round(seconds / float(per))), max_calls or 1 << 62)
        seconds = float("inf")
        dist.barrier(group=flags)
    launches0 = launch_total()
    mem_base = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        mem_base = torch.cuda.memory_allocated(dev)
    prof = None
    if plan.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    with (_span(trace.WINDOW_SPAN) if prof else contextlib.nullcontext()):
        win = closed_loop(call, pool, kept, keep, seconds, lambda: _sync(dev),
                          max_calls=max_calls, span=_span if prof else None,
                          catch=world == 1)
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    launches1 = launch_total()
    events = _stop(prof, dev) if prof else None
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    run = RankRun(
        rank=rank, world=world, config=cfg, keys_per_call=int(cfg["n"]),
        bytes_per_call=bytes_per_call, t0=plan.t0, first_call=win.first_call,
        latencies=win.latencies, enqueue=win.enqueue, window_s=win.window_s, calls=win.calls,
        launches=None if launches0 is None else launches1 - launches0,
        mem_base=mem_base, mem_peak=mem_peak,
        events=events, span=trace.span(events) if events else None,
        peak=plan.peaks.get(kind))
    readings = {}
    for m in plan.metrics:
        readings[m["name"]] = registry.metric(m["name"], plan.bench_dir).read(run)
    out = {"kind": kind, "readings": readings, "calls": win.calls, "failed": win.failed,
           "error": win.error, "mem_peak": mem_peak,
           "marks": [(name, t - plan.t0) for name, t in marks]}
    if events:
        lo, hi, tid = run.span
        out["busy_s"] = trace.busy_us(events, lo, hi) / 1e6
        out["window_s"] = (hi - lo) / 1e6
        out["device_ops"] = trace.device_ops(events, lo, hi)
        out["idle_gaps"] = trace.idle_gaps(events, lo, hi, tid)
    del run, events
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["compared"] = _check(plan, reference, pool, kept, win, rank, world, dev, flags)
    return out


def _stop(prof, dev) -> list:
    """Stop the profiler and read its trace back; the trace file, written
    under the temp dir, is deleted once read."""
    _sync(dev)
    prof.stop()
    tmp = tempfile.mkdtemp(prefix="perfbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return trace.load(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _check(plan, reference, pool, kept, win, rank, world, dev, flags):
    """The comparison that decides ``correct``, once the window has closed,
    against inputs made anew from the seed: each pool slot's inputs as the
    window left them, byte for byte (on each rank, its shard), and each
    slot's kept answer against the plain reference (on rank 0, with the
    ranks' shards gathered)."""
    totals = dict.fromkeys(reference.LIMITS, 0)
    totals.update(dict.fromkeys(CHECK_LIMITS, 0))
    changed = 0
    for slot, answer in enumerate(kept):
        inputs = generate.global_inputs(plan.config, plan.traffic, plan.seed, slot, dev,
                                        plan.bench_dir)
        mine = generate.shard(inputs, rank, world) if world > 1 else inputs
        changed += sum(mismatches(pool[slot][k], v) for k, v in mine.items())
        pool[slot] = mine = None
        if world > 1:
            answer = {k: _gather(v, world) for k, v in answer.items()}
        if rank == 0:
            if win.visits[slot] == 0:
                totals["unanswered"] += 1
            for k, v in reference.judge(inputs, answer).items():
                totals[k] += v
        del inputs
        kept[slot] = answer = None
    if world > 1:
        import torch.distributed as dist

        count = torch.tensor([changed], dtype=torch.int64)
        dist.all_reduce(count, group=flags)
        changed = int(count)
        dist.barrier(group=flags)
    totals["inputs_changed"] = changed
    return totals if rank == 0 else None
