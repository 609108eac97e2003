"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name: ``BENCHMARK.json`` at the checkout's root, then
``perfbench/configs/<config>.json``, ``perfbench/traffic/<traffic>.json``
(whose ``driver`` names the module under ``perfbench/drivers/`` that
drives it) and ``perfbench/metrics/<metric>.py``. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: every number compared,
beside its limit (also the last lines of standard error).

Exits non-zero, printing no result, without enough CUDA cards, or where
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import env  # noqa: E402


class Context:
    """What a driver is given: the cell's configuration and traffic, the
    run's seed, window and trace flag, the device, a scratch directory,
    the process's start time, and a fault to plant (tests only)."""

    def __init__(self, cfg, traffic, seed, seconds, trace, chips,
                 device="cuda", scratch=None, t_start=None, fault=None):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.chips, self.device = chips, device
        self.scratch = scratch
        self.t_start = T_START if t_start is None else t_start
        self.fault = fault


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, name: str):
    """(workload entry, configuration, traffic) of the cell ``name``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            cfg = load_json(HERE / "configs" / f"{w['config']}.json")
            traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
            return w, cfg, traffic
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell_name: str, reported) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def end_to_end(bench, cell_name):
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def per_layer(bench, cell_name, record, sl):
    """{name: {value, unit}} of the cell's per-layer metrics that found
    something to read."""
    reported = {m["name"] for m in end_to_end(bench, cell_name)}
    out = {}
    for m in bench["per_layer"]:
        if not applies(m, cell_name, reported):
            continue
        reader = load_module(HERE / "metrics" / f"{m['name']}.py")
        value = reader.read(record, sl)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(bench, name, seed, seconds, trace, device="cuda", fault=None):
    """Drive one run of cell ``name``: (the result object, the check
    lines). Needs the program importable (the checkout's root on the
    path)."""
    w, cfg, traffic = cell(bench, name)
    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py")
    scratch = env.scratch_dir()
    try:
        ctx = Context(cfg, traffic, seed, seconds, trace, w["chips"],
                      device=device, scratch=scratch, fault=fault)
        res = driver.run(ctx)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    checks = res["checks"]
    if trace:
        metrics = per_layer(bench, name, res["record"], res["slice"])
    else:
        metrics = {m["name"]: {"value": float(res["e2e"][m["name"]]),
                               "unit": m["unit"]}
                   for m in end_to_end(bench, name)}
    out = {"correct": checks.correct, "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": dict(res["device"])}
    sl = res["slice"]
    if trace and sl is not None:
        out["device"]["busy_s"] = sl.busy_s()
        out["device"]["window_s"] = sl.wall_s
        out["breakdown"] = {"device_ops": sl.top_ops(),
                            "idle_gaps": sl.idle_gaps()}
    out["checks"] = checks.as_dict()
    return out, checks.lines()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(HERE.parent / "BENCHMARK.json")
    w, _, _ = cell(bench, args.workload)
    env.setup_environment()
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < w["chips"]:
        print(f"perfbench: needs {w['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from harness import common

    card = common.power_limit()
    out, lines = execute(bench, args.workload, args.seed, args.seconds,
                         bool(args.trace))
    out["device"]["power_limit"] = card
    loaded = env.forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    print(f"perfbench: {args.workload} seed {args.seed} on {card}",
          file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
