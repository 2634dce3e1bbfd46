"""The whole-arc soak of the flagship: splash3d_1m through collapse, impact
and settle on the production default with the cap-8 policy (port of
`bench/soak_1m.py`).

It checks the audited policy over the arc (in-dispatch heals, the cap-8 →
cap-16 switch, minority repairs in the settle phase) and gives the
soak-average throughput: the policy's cost depends on the phase, so a
bench row's clean-phase speed is not the whole run's.

    python -m sph_tpu_torch.soak_1m [n_steps=5000] [reactive_theta] [repair_k]

`repair_k` unset means the production default (`step.default_repair_k`);
0 pins rebuild-only.  A probe line every 500 steps and whenever `healed`
changes; at the end the `SOAK RESULT` line.  Without a card it exits 1
with one line; `--device cpu` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
import time

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

SPD = 100


def soak(n_steps: int = 5000, reactive_theta: float | None = None,
         repair_k: int | None = None, device=None, *,
         scene: Scene | None = None) -> dict:
    """Run the soak (splash3d_1m, or `scene`) and return its counters and
    health: the soak-average rate and ms a step over the timed window (the
    warm dispatch excluded), healed, repaired, rebuilds, the mode changes
    with their steps, the final mode, max|v|, mean ρ, the active counts at
    the start and the end, the probe lines' values and the card's peak
    memory.  Prints the reference's lines."""
    dev = resolve_device(device)
    scene = scene if scene is not None else preset("splash3d_1m")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = init(scene, device=dev)
    state = prime(scene, state, method="pallas", device=dev)
    adv = make_audited_advance(
        scene, "pallas", SPD, sort_every=4, slot_resident=True,
        adaptive_cap=True, reactive_theta=reactive_theta,
        repair_k=repair_k, device=dev,
    )
    n = int(state.n_active())
    print(f"soak: n={n}, {n_steps} steps, adaptive flagship "
          f"(reactive_theta={reactive_theta}, repair_k={repair_k})",
          flush=True)
    modes = [(0, adv.mode)]
    probes = []
    healed_prev = 0
    # warm dispatch outside the timed loop
    state = adv(state)
    float(torch.sum(state.x))
    done = SPD
    if adv.mode != modes[-1][1]:
        modes.append((done, adv.mode))
    t0 = time.perf_counter()
    while done < n_steps:
        state = adv(state)
        float(torch.sum(state.x))
        done += SPD
        t_now = time.perf_counter() - t0
        if adv.mode != modes[-1][1]:
            modes.append((done, adv.mode))
        healed = adv.healed
        if done % 500 == 0 or healed != healed_prev:
            mx = float(torch.max(torch.abs(state.v)))
            rm = diagnostics.active_rho_mean(state)
            probes.append({"step": done, "wall_s": t_now, "healed": healed,
                           "repaired": adv.repaired, "mode": adv.mode,
                           "max_abs_v": mx, "rho_mean": rm})
            print(f"step {done:5d}  wall {t_now:8.1f}s  healed={healed} "
                  f"mode={adv.mode}  max|v|={mx:7.1f} "
                  f"rho_mean={rm:8.1f}", flush=True)
        healed_prev = healed
    t_all = time.perf_counter() - t0
    act = state.active
    assert bool(torch.isfinite(state.x[act]).all()), \
        "non-finite positions after soak"
    timed = n_steps - SPD
    avg = n * timed / t_all
    print(f"SOAK RESULT: {timed} timed steps in {t_all:.1f}s → "
          f"{avg:.3e} particle-steps/s soak-average "
          f"({t_all / timed * 1e3:.1f} ms/step); healed={adv.healed} "
          f"repaired={adv.repaired} final_mode={adv.mode}", flush=True)
    return {"n": n, "n_final": int(state.n_active()), "steps": done,
            "timed_steps": timed, "timed_s": t_all, "psteps_per_s": avg,
            "ms_per_step": t_all / timed * 1e3, "healed": adv.healed,
            "repaired": adv.repaired, "rebuilds": adv.rebuilds,
            "mode": adv.mode, "modes": modes,
            "max_abs_v": float(torch.max(torch.abs(state.v))),
            "rho_mean": diagnostics.active_rho_mean(state), "probes": probes,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "state": state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sph_tpu_torch.soak_1m")
    ap.add_argument("n_steps", nargs="?", type=int, default=5000)
    ap.add_argument("reactive_theta", nargs="?", type=float, default=None)
    ap.add_argument("repair_k", nargs="?", type=int, default=None,
                    help="unset: the production default; 0: rebuild-only")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    if device is None:
        return 1
    soak(args.n_steps, args.reactive_theta, args.repair_k, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
