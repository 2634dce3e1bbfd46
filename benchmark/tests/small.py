"""A small cell for the CPU tests: the splash3d_1m configurations' scene
cut to a column of 12³ particles on a floor of 40 × 2 × 40 static ones in
a 360 × 300 × 360 box (the same h, spacing, mass and physics), and an arc
of a few short frames."""

from __future__ import annotations

import copy
import json

from benchmark import spec

SPACING = 16.0 * 0.55


def small_cell(config: str = "splash3d_1m", steps: int = 24, spf: int = 8,
               draw=((1, 2),), limits: dict | None = None) -> spec.Cell:
    with open(spec.HERE / "configs" / f"{config}.json") as fh:
        cfg = json.load(fh)
    cfg = copy.deepcopy(cfg)
    scene = cfg["scene"]
    lo = 24.8
    scene["hi"] = [360.0, 300.0, 360.0]
    scene["blocks"] = [
        {"lo": [lo] * 3, "hi": [lo + 12 * SPACING] * 3, "velocity": None,
         "kind": 0},
        {"lo": [0.0, 0.0, 0.0], "hi": [352.0, 2 * SPACING, 352.0],
         "velocity": None, "kind": 1},
    ]
    # the floor is 2/3 of this scene's particles, and its half-supported
    # density pulls the mean down to ~0.86 of rest (at 1M it is 7%)
    cfg["guarantees"]["rho_dev"] = 0.25
    workload = {"traffic": "small", "steps": steps, "steps_per_frame": spf,
                "check": {"draw": [list(d) for d in draw]},
                "limits": limits or {"x_gap": 1e-3, "v_gap": 1e-3,
                                     "rho_gap": 1e-3, "diag_gap": 1e-4}}
    return spec.Cell(name=f"{config}.small", chips=1, config=cfg,
                     workload=workload, end_to_end=[], per_layer=[])
