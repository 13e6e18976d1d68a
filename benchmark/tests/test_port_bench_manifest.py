"""BENCHMARK.json against the contract's rules, and the file-by-name lookup
of every configuration, traffic mix, limit file, driver and metric reader."""

from __future__ import annotations

import importlib
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_json(harness.ROOT / "BENCHMARK.json")


def test_keys_and_limits(manifest):
    assert set(manifest) == TOP
    assert manifest["command"][1] == "benchmark/run.py"
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    cells = len(manifest["workloads"])
    # the full check of 24 cells fits in 43200 s
    assert 2 + 14 * 24 * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(manifest["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(1, cells // 4)


def test_names_units_and_sources(manifest):
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
    assert len(names) == len(set(names))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e


def test_every_cell_reports_enough(manifest):
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
        e2e = harness.metrics_of(manifest, w["name"], "end_to_end")
        layer = harness.metrics_of(manifest, w["name"], "per_layer")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
        for m in layer:        # each per-layer metric moves a metric its cells report
            assert m["moves"] in {x["name"] for x in e2e}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits", "drivers", "readers"])
def test_lookup_by_name(manifest, kind):
    for w in manifest["workloads"]:
        c = harness.cell(w["name"])
        if kind == "configs":
            assert c["config"]["name"] == w["config"]
            entry = next(x for x in manifest["configs"] if x["name"] == w["config"])
            assert entry["file"].startswith("benchmark/configs/") and entry["reduced"] == []
        elif kind == "traffic":
            assert "driver" in c["traffic"]
        elif kind == "limits":
            # an exact comparison has the limit 0
            assert c["limits"] and all(v >= 0 for v in c["limits"].values())
        elif kind == "drivers":
            assert hasattr(harness.driver(c["traffic"]), "check")
    if kind == "readers":
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("name", ["pigan-base", "pigan-optimized"])
def test_configs_match_the_program(manifest, name):
    from benchmark import program

    entry = next(x for x in manifest["configs"] if x["name"] == name)
    cfg = harness.load_json(harness.ROOT / entry["file"])
    pc = program.port_config(cfg)
    assert pc.data.spectrum_dim == cfg["spectrum_dim"] == 250
    assert list(pc.forward_model.hidden_dims) == [256, 512, 1024, 512, 256]


def test_no_file_outside_the_paths(manifest):
    for word in manifest["command"]:
        assert not word.startswith("/") and ".." not in word
    for entry in manifest["configs"]:
        assert entry["file"].startswith(manifest["paths"][0] + "/")
    importlib.import_module("benchmark.run")
