"""Make the settled checkpoints the bench's two `@settled` rows start from
(port of `bench/make_settled_state.py`).

Two regimes a from-init row cannot reach:

- splash3d_1m at step 3000: after the impact, the fluid settled against
  the floor; the regime where minority repair does its work.
- emitters3d filled: the scene starts empty and its three jets emit ~0.27
  particles a step, so it advances until at least 20,000 particles are
  active (~75-80k steps); the packed auto policy's regime.

The files (~40 MB each) are made on demand, never committed, at the paths
of the reference's table (`SETTLED`), which `bench_step` reads.

    python -m sph_tpu_torch.make_settled_state              # both, if absent
    python -m sph_tpu_torch.make_settled_state splash3d_1m  # make this one
    python -m sph_tpu_torch.make_settled_state emitters3d --device cuda:1

Without a card it exits 1 with one line; `--device cpu` runs the kernels'
plain versions on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import torch

from sph_tpu_torch import diagnostics
from sph_tpu_torch.params import Scene, preset
from sph_tpu_torch.platform import (
    add_device_flag,
    entry_device,
    resolve_device,
)
from sph_tpu_torch.state import init
from sph_tpu_torch.step import make_audited_advance, prime

_DIR = Path(__file__).resolve().parent.parent / "bench"

#: config -> (checkpoint path, stop criterion), the reference's table
#: (bench/make_settled_state.py:48-54).  `bench_step` reads the same table.
SETTLED = {
    "splash3d_1m": (str(_DIR / ".settled_1m_3000.npz"), dict(n_steps=3000)),
    "emitters3d": (str(_DIR / ".settled_emitters3d.npz"),
                   dict(min_active=20000, max_steps=120000)),
}

#: steps a dispatch
SPD = 100


def settled_path(config: str) -> str | None:
    ent = SETTLED.get(config)
    return ent[0] if ent else None


def regen(config: str, device=None, *, scene: Scene | None = None,
          path: str | None = None, crit: dict | None = None) -> dict:
    """Advance `config` (or `scene`) from init with the settled maker's
    advance until its stop criterion, write the checkpoint to `path`
    (default: the table's), and return what it did: the step, the active
    count, the policy's counters and final mode, max|v|, wall seconds and
    the card's peak memory.  Prints the reference's lines.  Raises
    SystemExit when `min_active` is not reached in `max_steps`."""
    dev = resolve_device(device)
    table_path, table_crit = SETTLED.get(config, (None, {}))
    path = path or table_path
    crit = dict(table_crit if crit is None else crit)
    scene = scene if scene is not None else preset(config)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = init(scene, device=dev)
    if scene.params.integrator == "leapfrog":
        state = prime(scene, state, method="pallas", device=dev)
    adv = make_audited_advance(
        scene, "pallas", SPD, sort_every=4, slot_resident=True,
        adaptive_cap=(config == "splash3d_1m"), device=dev,
    )
    modes = [(0, adv.mode)]
    t0 = time.perf_counter()
    done = 0
    limit = crit.get("n_steps", crit.get("max_steps"))
    while done < limit:
        state = adv(state)
        float(torch.sum(state.x))
        done += SPD
        n_act = int(state.n_active())
        if adv.mode != modes[-1][1]:
            modes.append((done, adv.mode))
        if done % 5000 == 0 or done == limit:
            print(f"{config}: step {done:6d}  n={n_act:7d}  "
                  f"wall {time.perf_counter() - t0:7.1f}s  "
                  f"healed={getattr(adv, 'healed', 0)}", flush=True)
        if "min_active" in crit and n_act >= crit["min_active"]:
            break
    wall = time.perf_counter() - t0
    n_act = int(state.n_active())
    if "min_active" in crit and n_act < crit["min_active"]:
        raise SystemExit(
            f"{config}: only {n_act} active after {done} steps "
            f"(wanted {crit['min_active']}) — raise max_steps"
        )
    act = state.active
    assert bool(torch.isfinite(state.x[act]).all()), "non-finite positions"
    diagnostics.save_checkpoint(path, state, scene)
    mx = diagnostics.active_max_abs_v(state)
    print(f"saved {path} at step {done} (n={n_act}, max|v|={mx:.1f})",
          flush=True)
    return {"config": config, "path": path, "step": done,
            "n_active": n_act, "healed": adv.healed,
            "repaired": adv.repaired, "rebuilds": adv.rebuilds,
            "mode": adv.mode, "modes": modes, "max_abs_v": mx,
            "wall_s": wall, "ms_per_step": wall / max(done, 1) * 1e3,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sph_tpu_torch.make_settled_state")
    ap.add_argument("configs", nargs="*", metavar="config",
                    help=f"any of {', '.join(SETTLED)} (default: both)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    unknown = [c for c in args.configs if c not in SETTLED]
    if unknown:
        ap.error(f"unknown config {unknown[0]!r} "
                 f"(one of {', '.join(SETTLED)})")
    device = entry_device(args.device)
    if device is None:
        return 1
    targets = args.configs or None
    for config in (targets or SETTLED):
        path, _ = SETTLED[config]
        if targets is None and os.path.exists(path):
            print(f"{config}: {path} exists — skipping (name it to regen)",
                  flush=True)
            continue
        regen(config, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
