"""BENCHMARK.json against the rules the benchmark keeps: every
configuration, traffic mix, limit and per-layer metric resolves to a file
by its name, names and units use the allowed characters, each per-layer
metric moves an end-to-end metric that every cell it lists reports, and
no cell asks for more than one card."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parent.parent
CHECKOUT = ROOT.parent
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"][:2] == ["python3", "perfbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + list(CELLS) + [m["name"] for m in METRICS])
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_resolves(config):
    path = CHECKOUT / config["file"]
    assert path.is_file() and path.parts[len(CHECKOUT.parts)] == "perfbench"
    body = json.loads(path.read_text())
    assert body["reduced"] == config["reduced"] == []
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    assert sum(c["file"] == config["file"] for c in BENCH["configs"]) == 1


@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_resolves(cell):
    w = CELLS[cell]
    assert w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    loaded = harness.load_cell(cell, BENCH)
    assert (ROOT / "traffic" / f"{w['traffic']}.json").is_file()
    assert (ROOT / "runners" / f"{loaded.mix['runner']}.py").is_file()
    assert set(loaded.limits["numbers"]), "a cell compares at least one number"
    assert "setup_s" in loaded.end_to_end and len(loaded.end_to_end) >= 2
    assert loaded.per_layer, "every cell reports a per-layer metric"
    for name in loaded.per_layer:
        assert (ROOT / "metrics" / f"{name}.py").is_file()


def test_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(metric):
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    moved = e2e[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert "workloads" not in moved or cell in moved["workloads"], (metric["name"], cell)


def test_layers_of_one_name():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"engine", "towers", "train step", "index", "kernels", "device"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    if m["name"] != "setup_s"])
def test_every_end_to_end_metric_is_computed(metric):
    from perfbench import e2e

    assert callable(e2e.metric(metric))
