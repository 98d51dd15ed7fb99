"""BENCHMARK.json against the benchmark's contract, every part found by its
name, a part added as a file found without an edit, and the imports of
every module of the benchmark."""
import ast
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from perfbench.harness import generate, registry

ROOT = registry.ROOT
BENCH = registry.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_text(w) for w in cmd)
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench).encode()) <= 64 * 1024


def test_names_units_and_entries(bench):
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.setdefault(group if group in ("configs", "workloads") else "metrics",
                             []).append(entry["name"])
    for group, ns in names.items():
        assert len(ns) == len(set(ns)), group
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _text(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    assert {c["name"] for c in bench["configs"]} == {w["config"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in SOURCES_E2E and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and _text(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_reports_what_the_contract_asks(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in registry.cell_metrics(bench, w["name"], traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = registry.cell_metrics(bench, w["name"], traced=True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_every_part_resolves_to_its_file(bench):
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.resolve().is_relative_to(BENCH)
        cfg = registry.config(bench, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        registry.module("entries", cfg["kind"])
        ref = registry.module("reference", cfg["kind"])
        assert ref.LIMITS and callable(ref.judge) and callable(ref.control)
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    for w in bench["workloads"]:
        assert registry.cell(bench, w["name"])["config"] == w["config"]
        assert registry.config(bench, w["config"])["chips"] == w["chips"]
        tr = registry.traffic(w["traffic"])
        assert callable(registry.module("keys", tr["keys"]["distribution"]).make)
        if tr.get("segments"):
            assert callable(registry.module("segments", tr["segments"]["layout"]).sizes)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.metric(m["name"]).read)


def test_a_part_added_as_a_file_is_found_without_an_edit(tmp_path, bench):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench")
    new = root / "perfbench"
    (new / "configs" / "added.json").write_text(json.dumps(
        {"name": "added", "kind": "flat_pairs", "n": 1024, "key_dtype": "uint32"}))
    (new / "traffic" / "added_mix.json").write_text(json.dumps(
        {"keys": {"distribution": "added_dist"}, "pool": 2}))
    (new / "keys" / "added_dist.py").write_text(
        "import torch\n\ndef make(gen, n, dtype, params, device):\n"
        "    return torch.full((n,), 3, dtype=torch.int32, device=device).view(dtype)\n")
    (new / "metrics" / "added_metric.py").write_text("def read(run):\n    return 1.5\n")
    (new / "metrics" / "keys_per_s.added.py").write_text("def read(run):\n    return 2.5\n")
    b = dict(bench, configs=bench["configs"] + [
        {"name": "added", "source": "x", "file": "perfbench/configs/added.json",
         "reduced": [], "why": "x"}],
        workloads=bench["workloads"] + [
        {"name": "added.mix", "config": "added", "traffic": "added_mix", "chips": 1,
         "why": "x"}],
        per_layer=bench["per_layer"] + [
        {"name": "added_metric", "unit": "ms", "better": "lower", "source": "host_clock",
         "layer": "entry", "moves": "keys_per_s", "workloads": ["added.mix"]}])
    assert registry.config(b, "added", root)["n"] == 1024
    tr = registry.traffic("added_mix", new)
    assert tr["pool"] == 2
    made = generate.global_inputs(registry.config(b, "added", root), tr, 1, 0, "cpu", new)
    assert made["keys"].view(torch.int32).eq(3).all()
    assert registry.metric("added_metric", new).read(None) == 1.5
    # a metric given apart to a group of cells reads as its base, unless it
    # has a reader of its own
    assert registry.metric("keys_per_s.other", new).__file__.endswith("keys_per_s.py")
    assert registry.metric("keys_per_s.added", new).read(None) == 2.5
    assert [m["name"] for m in registry.cell_metrics(b, "added.mix", traced=True)] == [
        "added_metric"]
    with pytest.raises(FileNotFoundError):
        registry.metric("missing", new)
    with pytest.raises(ValueError):
        registry.traffic("../escape", new)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _strings(path: Path):
    """String constants of a module, docstrings left out."""
    tree = ast.parse(path.read_text())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            yield node.value


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "tpu_radix_sort"), (f, name)
        if "tests" in f.relative_to(BENCH).parts:
            continue
        for s in _strings(f):  # what the command runs names no file of the JAX benchmark
            assert "bench.py" not in s and "benchmarks/" not in s, (f, s)


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        for name in _imports(f):
            assert name.split(".")[0] in ("torch", "numpy", "perfbench"), (f, name)
            assert not name.startswith("perfbench.") or name.startswith("perfbench.reference"), (
                f, name)
