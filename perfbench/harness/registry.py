"""Finds every part of a cell by its name.

``BENCHMARK.json`` names the cells, configurations and metrics. Each part
lives in a file of its own under the benchmark's folder, found by name, so
that a later change adds a configuration, a traffic mix, an entry or a
metric by adding a file and never by editing one:

- ``configs/<config>.json``: one deployment (its ``file`` in ``BENCHMARK.json``);
- ``traffic/<traffic>.json``: the parameters of one traffic mix, read by
  the general generator (``harness/generate.py``);
- ``keys/<distribution>.py``, ``segments/<layout>.py``: the key
  distributions and segment layouts a traffic file may name;
- ``entries/<kind>.py``: how a configuration's kind calls the program;
- ``reference/<kind>.py``: the plain reference and the comparison of that kind;
- ``metrics/<metric>.py``: one reader for each metric. A metric named
  ``<base>.<group>`` (one quantity reported apart by a group of cells, so
  that it carries its own bound or moves its group's metric) is read by
  ``metrics/<base>.py`` unless it has a file of its own.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has no cell named {name!r}")
    return found[0]


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    found = [c for c in bench["configs"] if c["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has no configuration named {name!r}")
    with open(Path(root) / found[0]["file"]) as f:
        return json.load(f)


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(Path(bench_dir) / "traffic" / f"{check_name(name)}.json") as f:
        return json.load(f)


def module(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``<bench_dir>/<kind>/<name>.py``, loaded from its file."""
    return module_at(Path(bench_dir) / kind / f"{check_name(name)}.py", f"{kind}.{name}")


def metric(name: str, bench_dir: Path = BENCH_DIR):
    """The reader of the metric `name` (``metrics/<name>.py``, or for
    ``<base>.<group>`` without a file of its own, ``metrics/<base>.py``)."""
    if "." in check_name(name) and not (Path(bench_dir) / "metrics" / f"{name}.py").is_file():
        name = name.split(".")[0]
    return module("metrics", name, bench_dir)


def module_at(path: Path, label: str):
    if not Path(path).is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        "_perfbench_" + label.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell_name: str, traced: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or,
    traced, the per-layer metrics that list the cell (or, without a
    ``workloads`` key, that move an end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}

    def listed(m):
        return cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved

    return [m for m in bench["per_layer"] if listed(m)]
