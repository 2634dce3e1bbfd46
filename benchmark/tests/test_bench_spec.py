"""BENCHMARK.json holds to its schema, and every cell resolves to its files:
its configuration, its traffic and the readers of its per-layer metrics."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all((spec.ROOT / p).is_dir() for p in BENCH["paths"])
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.fullmatch(n) for n in names), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.load_cell(cell)
    assert c.chips in (1, 4)
    scene = c.config["scene"]
    assert scene["params"]["precision"] == "fp32"
    assert c.workload["steps"] % c.workload["steps_per_frame"] == 0
    frames = c.workload["steps"] // c.workload["steps_per_frame"]
    for a, b in c.workload["check"]["draw"]:
        assert 0 <= a <= b < frames
    assert set(c.workload["limits"]) == {"x_gap", "v_gap", "rho_gap",
                                         "diag_gap"}
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in names


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        with open(spec.ROOT / c["file"]) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert (spec.ROOT / cfg["reference"]).is_file()
