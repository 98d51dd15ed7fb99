"""Runs one cell of ``BENCHMARK.json`` once; see ``harness/main.py``.

    python3 perfbench/run.py --workload flat_u32_pairs.uniform --seed 1 --seconds 15 --trace 0
"""
import time

T0 = time.perf_counter()  # set-up is timed from here, before any import

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    from perfbench.harness.main import cli

    sys.exit(cli(sys.argv[1:], T0))
