"""Cap-overflow populations through a whole flow (port of
`bench/measure_spill.py`): the evidence behind the cap-8 design.

After each dispatch of 100 per-step steps on the preset's own lattice it
counts the particles that a cell cap would drop, Σ_cells max(count − cap,
0), for `cap` and for 2·cap, and the worst cell occupancy.

    python -m sph_tpu_torch.measure_spill [config=dam3d_100k] [n_steps=3000] [cap=8]

It prints every fifth dispatch and the `WORST` line.  Without a card it
exits 1 with one line; `--device cpu` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys

import torch

from sph_tpu_torch import neighbors
from sph_tpu_torch.params import Scene, preset
from sph_tpu_torch.platform import (
    add_device_flag,
    entry_device,
    resolve_device,
)
from sph_tpu_torch.state import init
from sph_tpu_torch.step import make_advance, prime

SPD = 100


def spill_counts(state, grid, cap: int) -> tuple:
    """(spilled over `cap`, worst occupancy, spilled over 2·cap) of the
    active particles on `grid`'s cells."""
    _, flat = neighbors.cell_index(state.x, state.active, grid)
    counts = torch.bincount(flat.long(), minlength=grid.n_rows)[: grid.n_cells]
    return tuple(int(c) for c in torch.stack([
        torch.sum(torch.clamp(counts - cap, min=0)),
        torch.max(counts),
        torch.sum(torch.clamp(counts - 2 * cap, min=0)),
    ]).cpu())


def measure(name: str = "dam3d_100k", n_steps: int = 3000, cap: int = 8,
            device=None, *, scene: Scene | None = None) -> dict:
    """Run `name` (or `scene`) per step in dispatches of 100 and return the
    counts after each dispatch (`rows`: step, spilled, max_occ, spilled2)
    and the worst of each.  Prints the reference's lines."""
    dev = resolve_device(device)
    scene = scene if scene is not None else preset(name)
    grid = neighbors.GridSpec.for_scene(scene)
    state = init(scene, device=dev)
    if scene.params.integrator == "leapfrog":
        state = prime(scene, state, method="pallas", device=dev)
    adv = make_advance(scene, "pallas", steps_per_dispatch=SPD, device=dev)
    rows = []
    worst_tot, worst_occ, worst_tot2 = 0, 0, 0
    for k in range(n_steps // SPD):
        state = adv(state)
        tot, occ, tot2 = spill_counts(state, grid, cap)
        rows.append({"step": int(state.step), "spilled": tot,
                     "max_occ": occ, "spilled2": tot2})
        worst_tot = max(worst_tot, tot)
        worst_occ = max(worst_occ, occ)
        worst_tot2 = max(worst_tot2, tot2)
        if k % 5 == 0:
            print(f"step {int(state.step):6d}: spilled(cap={cap})={tot:6d} "
                  f"max_occ={occ:3d} spilled(cap={2*cap})={tot2:4d}",
                  flush=True)
    print(f"WORST over {n_steps} steps: spilled(cap={cap})={worst_tot} "
          f"max_occ={worst_occ} spilled(cap={2*cap})={worst_tot2}",
          flush=True)
    return {"config": name, "cap": cap, "rows": rows,
            "worst_spilled": worst_tot, "worst_max_occ": worst_occ,
            "worst_spilled2": worst_tot2, "state": state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sph_tpu_torch.measure_spill")
    ap.add_argument("config", nargs="?", default="dam3d_100k")
    ap.add_argument("n_steps", nargs="?", type=int, default=3000)
    ap.add_argument("cap", nargs="?", type=int, default=8)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    if device is None:
        return 1
    measure(args.config, args.n_steps, args.cap, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
