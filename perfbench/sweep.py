"""The knee of a serving cell: its service set up once, then open-loop
traffic at each of a list of fixed rates, ``--seconds`` each, on the same
schedule scaled to the rate. For each rate: requests sent and failed, the
median, 95th and 99th percentile latency from due to done, the completed
rate, and the backlog (how late the last request finished after it was
due, and the median latency of the last quarter against the first).

    python3 perfbench/sweep.py --workload <cell> --seed <n> \\
        --seconds <s> --rates <r> [<r> ...]

One JSON line a rate. The knee is the highest rate whose backlog does not
grow over its window; the cell's ``rate_per_s`` is set at about 4/5 of it
(PERF.md). Needs a CUDA card; the benchmark's runs never call it.
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
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    env.setup_environment()
    import numpy as np
    import torch

    from harness import common

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    spec = bench.load_json(HERE.parent / "BENCHMARK.json")
    w, cfg, traffic = bench.cell(spec, args.workload)
    driver = bench.load_module(HERE / "drivers" / f"{traffic['driver']}.py")
    scratch = env.scratch_dir()
    try:
        ctx = bench.Context(cfg, traffic, args.seed, args.seconds, False,
                            w["chips"], scratch=scratch)
        service, _, _, _, _, _ = driver.setup(ctx)
        print(json.dumps({"card": common.power_limit()}), flush=True)
        for rate in args.rates:
            tr = dict(traffic, rate_per_s=rate)
            sched = driver.Traffic(cfg, tr, args.seed, tr["bank_size"],
                                   args.seconds)
            reqs, t0, late = driver.offer(service, sched, tr, 0, set())
            lat = [None if r["done"] is None else r["done"] - r["due"]
                   for r in reqs]
            done = [r["done"] for r in reqs if r["done"] is not None]
            q = max(len(lat) // 4, 1)
            print(json.dumps({
                "rate": rate, "sent": len(reqs),
                "failed": sum(x is None for x in lat),
                "p50_ms": common.percentile(lat, 50) * 1e3,
                "p95_ms": common.percentile(lat, 95) * 1e3,
                "p99_ms": common.percentile(lat, 99) * 1e3,
                "completed_per_s": len(done) / (max(done) - t0),
                "last_late_s": reqs[-1]["done"] - reqs[-1]["due"]
                if reqs[-1]["done"] else None,
                "p50_first_quarter_ms": common.percentile(lat[:q], 50) * 1e3,
                "p50_last_quarter_ms": common.percentile(lat[-q:], 50) * 1e3,
                "generator_late_p99_ms": float(np.percentile(late, 99)) * 1e3,
                "batch_sizes": service.stats()["batch_sizes"]}),
                flush=True)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
