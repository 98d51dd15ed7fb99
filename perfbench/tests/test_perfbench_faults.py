"""A whole run on the CPU, the harness's look for a card skipped, with the
program's answers sound and with the timed path broken underneath:
``correct`` comes out true, then false for each fault the cells can have
(the answer returned unchanged, half of the keys left out, an answer
altered where it is produced, the inputs overwritten by their sorted
answer, and on the mesh the exchange between the ranks left out). Also the
command's refusals."""
import json
import shutil
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from perfbench.harness import main, registry
from perfbench.harness.cell import Plan

ZIPF_SMALL = {"layout": "zipf", "count": 64, "exponent": 1.3, "sizes_seed": 0}

FAULTS = {
    "unchanged": """
        def call(program, inputs, env):
            return {k: v.clone() for k, v in inputs.items() if k != "offsets"}
    """,
    "half_left_out": """
        import torch
        ENTRY = {entry!r}

        def call(program, inputs, env):
            from perfbench.harness import registry
            out = registry.module("entries", ENTRY).call(program, inputs, env)
            half = inputs["keys"].numel() // 2
            return {k: torch.cat([v[:half], inputs[k][half:]]) for k, v in out.items()}
    """,
    "altered": """
        import torch
        ENTRY = {entry!r}

        def call(program, inputs, env):
            from perfbench.harness import registry
            out = registry.module("entries", ENTRY).call(program, inputs, env)
            out["keys"].view(torch.int32)[7] ^= 1
            return out
    """,
    "sorted_in_place": """
        ENTRY = {entry!r}

        def call(program, inputs, env):
            from perfbench.harness import registry
            out = registry.module("entries", ENTRY).call(program, inputs, env)
            for k, v in out.items():
                inputs[k].copy_(v)
            return out
    """,
    "exchange_left_out": """
        def call(program, inputs, env):
            keys, values = program.sort(inputs["keys"], inputs["values"], values_are_ranks=True)
            return {"keys": keys, "values": values}
    """,
}


def _plan(cell_name, n, *, traffic=None, entry_file=None, trace=False, seconds=0.3):
    bench = registry.benchmark()
    cell = registry.cell(bench, cell_name)
    cfg = dict(registry.config(bench, cell["config"]), n=n)
    tr = registry.traffic(cell["traffic"])
    if tr.get("segments", {}).get("layout") == "zipf":
        tr = dict(tr, segments=ZIPF_SMALL)
    return Plan(cell=cell, config=cfg, traffic=traffic or tr,
                metrics=registry.cell_metrics(bench, cell_name, trace), seed=2**31 + 77,
                seconds=seconds, trace=trace, t0=time.perf_counter(), device_type="cpu",
                entry_file=entry_file)


def _fault(tmp_path, name, kind):
    path = tmp_path / f"{name}.py"
    path.write_text(textwrap.dedent(FAULTS[name]).replace("{entry!r}", repr(kind)))
    return str(path)


ONE_CHIP = [("flat_u32_pairs.uniform", 1 << 12), ("segmented_u32.zipf", 1 << 13),
            ("segmented_u32.equal", 1 << 13)]


@pytest.mark.parametrize("cell_name,n", ONE_CHIP)
def test_a_sound_run_is_correct(cell_name, n):
    plan = _plan(cell_name, n)
    result = main.execute(plan)
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 3
    assert list(result)[-1] == "compared"
    # every end-to-end metric of the cell but the card's memory, which the CPU lacks
    assert set(result["metrics"]) == {m["name"] for m in plan.metrics} - {"peak_mem_gib"}
    assert all(c["value"] == 0 for c in result["compared"].values())


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered", "sorted_in_place"])
@pytest.mark.parametrize("cell_name,n", ONE_CHIP)
def test_a_broken_timed_path_is_not_correct(tmp_path, cell_name, n, fault):
    kind = registry.config(registry.benchmark(), registry.cell(
        registry.benchmark(), cell_name)["config"])["kind"]
    result = main.execute(_plan(cell_name, n, entry_file=_fault(tmp_path, fault, kind)))
    assert not result["correct"], result["compared"]
    if fault == "sorted_in_place":
        # every answer is right: only the check of the inputs sees that the
        # window timed already sorted inputs after each slot's first visit
        got = {k: c["value"] for k, c in result["compared"].items()}
        assert got.pop("inputs_changed") > 0 and not any(got.values()), got


def test_a_traced_run_reports_the_per_layer_metrics_it_can_read():
    result = main.execute(_plan("segmented_u32.zipf", 1 << 13, trace=True))
    assert result["correct"]
    # no card: nothing read from the device, and no roofline share of 0
    assert set(result["metrics"]) == {"host_enqueue_ms.segmented", "launches_per_call.segmented"}
    assert result["device"]["window_s"] > 0 and "breakdown" in result


@pytest.mark.parametrize("fault", [None, "exchange_left_out", "altered", "sorted_in_place"])
def test_the_mesh_cell_over_four_gloo_ranks(tmp_path, fault):
    entry = _fault(tmp_path, fault, "mesh_pairs") if fault else None
    result = main.execute(_plan("mesh4_u32_pairs.uniform", 1 << 12, entry_file=entry,
                                seconds=0.2))
    assert result["device"]["count"] == 4
    assert result["correct"] == (fault is None), result["compared"]


def _command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "flat_u32_pairs.uniform",
         "--seed", "5", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _command(registry.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr


@pytest.mark.gpu
def test_on_the_card_a_short_run_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _command(registry.ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_on_the_card_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    for rel in registry.benchmark()["paths"]:
        shutil.copytree(registry.ROOT / rel, tmp_path / rel,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
