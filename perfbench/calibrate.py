"""Readings of a cell's control: the plain reference in the program's
place, at the precision below the configuration's (float8 e4m3 operands
for its bfloat16), on the sample a run of each seed would check. These are
the upper readings the limits of ``correct`` are set below (PERF.md).

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--mode fp8]

One JSON line a seed: {"seed", "mode", "checks": {name: {value, limit}}}.
Needs a CUDA card; the benchmark's runs never call it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import env  # noqa: E402
import run as bench  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", default="fp8")
    args = p.parse_args(argv)
    env.setup_environment()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    spec = bench.load_json(HERE.parent / "BENCHMARK.json")
    w, cfg, traffic = bench.cell(spec, args.workload)
    driver = bench.load_module(HERE / "drivers" / f"{traffic['driver']}.py")
    for seed in args.seeds:
        scratch = env.scratch_dir()
        try:
            ctx = bench.Context(cfg, traffic, seed, args.seconds, False,
                                w["chips"], scratch=scratch)
            checks = driver.control(ctx, args.mode)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        print(json.dumps({"seed": seed, "mode": args.mode,
                          "checks": checks.as_dict()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
