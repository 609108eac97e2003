"""Every cell, configuration, traffic mix and metric that BENCHMARK.json
names is found by name, and the file keeps the benchmark's format."""

import json
import re

import pytest

import tiny
from run import HERE, load_json, load_module

BENCH = load_json(HERE.parent / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_loads(cfg):
    assert NAME.match(cfg["name"])
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    data = json.loads((HERE.parent / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert cfg["file"] == f"perfbench/configs/{cfg['name']}.json"
    assert data["reduced"] == cfg["reduced"] == []
    for ref in data["reference"]:
        assert (HERE / ref).is_file()
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    traffic = tiny.load("traffic", cell["traffic"])
    driver = load_module(HERE / "drivers" / f"{traffic['driver']}.py")
    assert callable(driver.run) and callable(driver.control)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    reported = [m["name"] for m in BENCH["end_to_end"]
                if "workloads" not in m or cell["name"] in m["workloads"]]
    assert "setup_s" in reported and len(reported) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]])
               for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_declared(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        return
    reader = load_module(HERE / "metrics" / f"{metric['name']}.py")
    assert callable(reader.read)
    assert reader.read({}, None) is None  # nothing to read, nothing read
    moves = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
    assert moves, metric["moves"]
    for cell in metric["workloads"]:
        assert cell in moves[0].get("workloads", [cell])
    if "_roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"client", "interpreter", "server", "engine", "graphs",
                      "model", "kernels", "modules", "device", "step",
                      "data"}
