"""What a cell is, read from `BENCHMARK.json` and the files it names.

Everything that belongs to one configuration, one cell or one per-layer
metric sits in a file of its own, found by name:

- a configuration in `configs/<config>.json` (the scene as it is run, the
  program's path flags and the guarantees it states);
- a cell's traffic in `workloads/<cell>.json` (the arc a pass simulates and
  the frames the reference checks, with their limits);
- a per-layer metric's reader in `metrics/<metric>.py`, a module with
  `read(obs) -> float | None`.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    workload: dict        # workloads/<cell>.json
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _reported(metric: dict, cell: str, e2e_names: set) -> bool:
    """A per-layer metric is reported in the cells it lists, or without a
    list in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / cfg["file"]) as fh:
        config = json.load(fh)
    with open(HERE / "workloads" / f"{name}.json") as fh:
        workload = json.load(fh)
    if workload.get("traffic") != w["traffic"]:
        raise ValueError(f"workloads/{name}.json is traffic "
                         f"{workload.get('traffic')!r}, BENCHMARK.json says "
                         f"{w['traffic']!r}")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reported(m, name, names)]
    return Cell(name=name, chips=w["chips"], config=config, workload=workload,
                end_to_end=e2e, per_layer=layer)


def reader(metric: str):
    """The `read` function of `metrics/<metric>.py`, loaded by path, since
    a metric's name may hold `.` or `-`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
