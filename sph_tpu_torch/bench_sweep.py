"""Cell-cap sweep (port of `bench/bench_sweep.py`): the pair work grows
with cap², and the physics needs cap ≥ the worst cell occupancy, so the
cap is chosen from throughput and dropped particles measured together.

    python -m sph_tpu_torch.bench_sweep [config=dam3d_100k] [steps=50]

For caps 8, 16 and 32: one warm dispatch of `steps` per-step steps on the
cap's lattice, one timed dispatch (each ended by a host fetch), then the
state's `slot_overflow` (particles dropped by the cell cap, row
overflow).  A cap whose run raises prints `FAIL` and the sweep goes on, as
in the reference.  Without a card it exits 1 with one line; `--device
cpu` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from sph_tpu_torch import neighbors, pallas_step
from sph_tpu_torch.params import Scene, preset
from sph_tpu_torch.platform import (
    add_device_flag,
    entry_device,
    resolve_device,
)
from sph_tpu_torch.state import init
from sph_tpu_torch.step import make_advance, prime

CAPS = (8, 16, 32)


def sweep(name: str = "dam3d_100k", steps: int = 50, device=None, *,
          scene: Scene | None = None) -> list:
    """One row a cap of CAPS: {cap, ms_per_step, psteps_per_s, dropped,
    row_over, n, state} or {cap, fail}.  Prints the reference's lines."""
    dev = resolve_device(device)
    scene = scene if scene is not None else preset(name)
    rows = []
    for cap in CAPS:
        grid = neighbors.GridSpec.for_scene(scene, cap=cap)
        try:
            sg = pallas_step.slot_grid(grid)
            state = init(scene, device=dev)
            if scene.params.integrator == "leapfrog":
                state = prime(scene, state, method="pallas", device=dev)
            adv = make_advance(scene, "pallas", steps, grid=grid, device=dev)
            state = adv(state)
            float(torch.sum(state.x))
            t0 = time.perf_counter()
            state = adv(state)
            float(torch.sum(state.x))
            dt = (time.perf_counter() - t0) / steps
            cell_over, row_over = (int(c) for c in pallas_step.slot_overflow(
                state.x, state.active, grid, sg))
            n = int(state.n_active())
            print(f"cap={cap:3d}  {dt*1e3:9.3f} ms/step  "
                  f"{n/dt:12.3e} psteps/s  dropped={cell_over} "
                  f"row_over={row_over}", flush=True)
            rows.append({"cap": cap, "ms_per_step": dt * 1e3,
                         "psteps_per_s": n / dt, "dropped": cell_over,
                         "row_over": row_over, "n": n, "state": state})
        except Exception as e:  # noqa: BLE001 — a cap's failure is its line
            print(f"cap={cap:3d}  FAIL {type(e).__name__}: {str(e)[:90]}",
                  flush=True)
            rows.append({"cap": cap, "fail": f"{type(e).__name__}: {e}"})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sph_tpu_torch.bench_sweep")
    ap.add_argument("config", nargs="?", default="dam3d_100k")
    ap.add_argument("steps", nargs="?", type=int, default=50)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    if device is None:
        return 1
    sweep(args.config, args.steps, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
