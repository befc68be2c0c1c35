"""``BENCHMARK.json`` keeps to the benchmark's contract, and ``run.py``
finds every configuration, traffic mix and per-layer metric by its name."""

import ast
import os
import re

import pytest

from conftest import ROOT, load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MANIFEST = load("BENCHMARK.json")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == TOP_KEYS
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    cells = len(MANIFEST["workloads"])
    assert 2 + 14 * 24 <= 43200  # the check's own plan, at 24 cells
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200
    assert 1 <= cells <= 24


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_plain(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(set(names)) == len(names)
    for name in names:
        assert NAME.match(name), name


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"]
                         + MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in MANIFEST["end_to_end"]:
        allowed |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        allowed |= {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200
        assert "\n" not in metric["layer"] and "\t" not in metric["layer"]
    assert set(metric) <= allowed and set(metric) >= allowed - {"workloads"}
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in MANIFEST["workloads"]}
    assert set(metric.get("workloads", [])) <= cells


def test_setup_is_an_end_to_end_metric_of_every_cell():
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", MANIFEST["workloads"],
                         ids=lambda c: c["name"])
def test_every_cell_reports_and_is_found(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    config = load(configs[cell["config"]]["file"])
    assert config["name"] == cell["config"]
    assert os.path.exists(os.path.join(ROOT, "benchmark", "reference",
                                       f"{config['reference']}.py"))
    traffic = load("benchmark", "traffic", f"{cell['traffic']}.json")
    assert os.path.exists(os.path.join(ROOT, "benchmark", "lib",
                                       f"{traffic['kind']}_loop.py"))
    reports = [m for m in MANIFEST["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])]
    assert len(reports) >= 2
    layer = [m for m in MANIFEST["per_layer"]
             if cell["name"] in m["workloads"]]
    assert layer
    names = {m["name"] for m in reports}
    for m in layer:
        assert m["moves"] in names


def test_pairs_of_config_and_traffic_appear_once():
    pairs = [(c["config"], c["traffic"]) for c in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {c["config"] for c in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


@pytest.mark.parametrize("config", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config_entries(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("benchmark/")
    data = load(config["file"])
    assert data["reduced"] == config["reduced"]
    assert set(data["limits"]) and all(v > 0 for v in data["limits"].values())


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(metric):
    path = os.path.join(ROOT, "benchmark", "metrics", f"{metric['name']}.py")
    tree = ast.parse(open(path).read())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
               for n in tree.body)


def test_rooflines_and_mfu_are_named_so():
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
