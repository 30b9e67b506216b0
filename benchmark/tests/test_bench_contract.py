"""BENCHMARK.json keeps to the benchmark's contract, and every cell's
configuration, traffic and metric readers are found by name."""

import json
import re

import pytest

from benchmark import harness, traffic

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


# what a program module gives (benchmark/programs/__init__.py)
CONTRACT = ("traffic", "build", "drive", "verify", "kernel_shapes", "limit_names", "faults",
            "readings")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            extra = set(entry) - KEYS[group]
            assert extra <= ({"workloads"} if group in ("end_to_end", "per_layer") else set())
            assert KEYS[group] <= set(entry)
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got)), group
    for c in BENCH["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_command_and_paths():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/") and ".." not in p
    assert any(w.startswith(BENCH["paths"][0] + "/") for w in cmd[1:])


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_what_its_per_layer_metrics_move(cell):
    c = harness.find_cell(BENCH, cell)[0]
    e2e = {m["name"] for m in harness.metrics_for(BENCH, c, "end_to_end")}
    per_layer = harness.metrics_for(BENCH, c, "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for m in per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    c, config = harness.find_cell(BENCH, cell)
    assert config["name"] == c["config"]
    assert isinstance(traffic.load(c["traffic"]), dict)
    prog = harness.program(config)
    for name in CONTRACT:
        assert callable(getattr(prog, name)), name
    assert set(config["limits"]) == prog.limit_names(config)
    for kind in ("end_to_end", "per_layer"):
        for m in harness.metrics_for(BENCH, c, kind):
            assert callable(harness.reader(m["name"]))


def test_config_files_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(BENCH["paths"][0] + "/configs/")
