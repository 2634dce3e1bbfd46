"""The production policy's soaks of the emitter and interaction scenes
(port of `bench/soak_emitters.py`): emitters3d filled from empty through
jets to a pool, and vortex2d, the 90k rotating-stir pool.

Both run `make_audited_advance` as `run()` and the command line do (the
auto-rebuild resident path, the membership audit, `repair_k` unset → the
capacity-keyed default; on emitters3d the packed auto policy), print the
counters at every probe and check a healthy finish.  The emitters3d run
also makes the full settled state (the scene is a live render loop, so
its long-run regime is the filled one).

    python -m sph_tpu_torch.soak_emitters emitters3d [n_steps=260000] [save_path]
    python -m sph_tpu_torch.soak_emitters vortex2d   [n_steps=5000]

The command's default `save_path` for emitters3d is the reference's,
`bench/.settled_emitters3d_full.npz`, a committed file: pass another path
unless that file is to be replaced.  `soak()` saves only where it is
told.  Without a card the command exits 1 with one line; `--device cpu`
runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
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
from sph_tpu_torch.step import default_repair_k, make_audited_advance, prime

_DIR = Path(__file__).resolve().parent.parent / "bench"
DEFAULTS = {"emitters3d": 260_000, "vortex2d": 5_000}
FULL_SETTLED = str(_DIR / ".settled_emitters3d_full.npz")
SPD = 100


def probe_every(n_steps: int) -> int:
    """Steps between probe lines (the reference's formula)."""
    return max(1000, n_steps // 40 // 100 * 100)


def soak(config: str = "emitters3d", n_steps: int | None = None,
         save: str | None = None, device=None, *,
         scene: Scene | None = None) -> dict:
    """Soak `config` (or `scene`) for `n_steps` (default `DEFAULTS`), save
    the final state to `save` when given, and return the counters and
    health: the whole-run ms a step (the warm dispatch excluded), the
    active count, healed, repaired, rebuilds, the mode changes with their
    steps, the final mode, max|v| over the active particles, mean ρ, the
    probes and the card's peak memory.  Prints the reference's lines."""
    dev = resolve_device(device)
    n_steps = DEFAULTS[config] if n_steps is None else n_steps
    scene = scene if scene is not None else preset(config)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = init(scene, device=dev)
    if scene.params.integrator == "leapfrog":
        state = prime(scene, state, method="pallas", device=dev)
    adv = make_audited_advance(
        scene, "pallas", SPD, sort_every=4, slot_resident=True, device=dev,
    )
    rk = default_repair_k(scene, auto=True)
    print(f"soak {config}: {n_steps} steps, production policy "
          f"(repair_k default resolves to {rk}), capacity={state.capacity}",
          flush=True)
    modes = []
    state = adv(state)       # warm dispatch outside the timed loop
    float(torch.sum(state.x))
    done, t0 = SPD, time.perf_counter()
    modes.append((done, adv.mode))
    window_t0, window_done = t0, done
    every = probe_every(n_steps)
    probes = []
    while done < n_steps:
        state = adv(state)
        float(torch.sum(state.x))
        done += SPD
        if adv.mode != modes[-1][1]:
            modes.append((done, adv.mode))
        if done % every == 0:
            t_now = time.perf_counter()
            n_act = int(state.n_active())
            mx = diagnostics.active_max_abs_v(state)
            rm = diagnostics.active_rho_mean(state, floor=1)
            ms = (t_now - window_t0) / (done - window_done) * 1e3
            probes.append({"step": done, "n": n_act, "ms_per_step": ms,
                           "mode": adv.mode, "healed": adv.healed,
                           "repaired": adv.repaired, "max_abs_v": mx,
                           "rho_mean": rm})
            print(f"step {done:7d}  wall {t_now - t0:9.1f}s  n={n_act:6d}  "
                  f"{ms:7.2f} ms/step  mode={adv.mode} "
                  f"healed={adv.healed} repaired={adv.repaired}  "
                  f"max|v|={mx:7.1f} rho_mean={rm:9.2f}", flush=True)
            window_t0, window_done = t_now, done
    t_all = time.perf_counter() - t0
    act = state.active
    assert bool(torch.isfinite(state.x[act]).all()), \
        "non-finite positions after soak"
    n_final = int(act.sum())
    timed = n_steps - SPD
    print(f"SOAK RESULT {config}: {timed} timed steps in {t_all:.1f}s "
          f"({t_all / timed * 1e3:.2f} ms/step whole-run); "
          f"n_final={n_final} mode={adv.mode} healed={adv.healed} "
          f"repaired={adv.repaired}; finish healthy", flush=True)
    if save:
        diagnostics.save_checkpoint(save, state, scene)
        print(f"saved final state -> {save}", flush=True)
    return {"config": config, "steps": done, "timed_steps": timed,
            "timed_s": t_all, "ms_per_step": t_all / timed * 1e3,
            "n_final": n_final, "healed": adv.healed,
            "repaired": adv.repaired, "rebuilds": adv.rebuilds,
            "repair_k": rk, "mode": adv.mode, "modes": modes,
            "max_abs_v": diagnostics.active_max_abs_v(state),
            "rho_mean": diagnostics.active_rho_mean(state, floor=1),
            "probes": probes,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "state": state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sph_tpu_torch.soak_emitters")
    ap.add_argument("config", nargs="?", default="emitters3d",
                    choices=sorted(DEFAULTS))
    ap.add_argument("n_steps", nargs="?", type=int, default=None)
    ap.add_argument("save_path", nargs="?", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    if device is None:
        return 1
    save = args.save_path or (FULL_SETTLED if args.config == "emitters3d"
                              else None)
    soak(args.config, args.n_steps, save, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
