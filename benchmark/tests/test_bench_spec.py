"""BENCHMARK.json against the contract's rules, and every name in it
resolving to its files."""

import json
import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return harness.spec()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["benchmark"]
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(m["layer"])
        if m["name"].rsplit(".", 1)[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in bench["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] == 1 and LINE.match(c["why"]) and NAME.match(c["traffic"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and c["file"].startswith("benchmark/")


def test_every_cell_reports_setup_another_e2e_and_a_layer(bench):
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(bench, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = harness.cell_metrics(bench, cell["name"], "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in e2e


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(bench, kind):
    for m in bench[kind]:
        assert callable(harness.reader(m["name"]))


def test_every_cell_resolves(bench):
    for cell in bench["workloads"]:
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
        assert os.path.exists(os.path.join(harness.ROOT, conf["file"]))
        traffic = harness.load_json(harness.HERE, "traffic", f"{cell['traffic']}.json")
        assert os.path.exists(os.path.join(harness.HERE, "entries", f"{traffic['entry']}.py"))
        limits = harness.load_json(harness.HERE, "workloads", f"{cell['name']}.json")["limits"]
        assert limits


def test_every_config_is_used(bench):
    used = {c["config"] for c in bench["workloads"]}
    assert {c["name"] for c in bench["configs"]} == used


def test_file_names_use_name_characters():
    for dirpath, dirs, files in os.walk(harness.HERE):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".cache")]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), harness.ROOT)
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel
