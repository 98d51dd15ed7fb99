"""The control of a cell's check: the plain reference put in the
program's place with one guarantee that the configuration states broken
(``reference/<kind>.py`` ``control``), judged by the cell's own comparison
at the cell's own size. Each seed prints one JSON line with the numbers
compared beside their limits; a sound check reads above a limit on every
seed. The benchmark's runs never run it.

    python3 perfbench/control.py --workload segmented_u32.zipf --seeds 11 12 13

A cell across cards is judged on its global array, so its control runs on
one card at the global size.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

if __name__ == "__main__":
    import argparse

    import torch

    from perfbench.harness import generate, registry

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    reference = registry.module("reference", cfg["kind"])
    dev = torch.device(args.device)
    for seed in args.seeds:
        inputs = generate.global_inputs(cfg, traffic, seed, 0, dev)
        numbers = reference.judge(inputs, reference.control(inputs))
        print(json.dumps({"workload": args.workload, "seed": seed, "compared": {
            k: {"value": v, "limit": reference.LIMITS[k]} for k, v in numbers.items()},
            "fails": any(v > reference.LIMITS[k] for k, v in numbers.items())}), flush=True)
        del inputs
