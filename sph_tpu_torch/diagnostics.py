"""Diagnostics, watchdog, checkpoint/resume and the checked step (port of
`sph_tpu/diagnostics.py`).

- `scalar_pack`: one small reduction on the device per frame (max |v|,
  density stats, total momentum, kinetic energy, active count), fetched
  in one transfer.
- `Watchdog`: halts on NaN or exploding fetched scalars;
  `inject_nan` is the fault to check it with.
- checkpoints: one `.npz` holds the eight `State` fields and the scene as
  JSON bytes under `__scene_json__`.  The format is the reference's, so a
  file written by either package is read by the other and a resume is
  bitwise.
- `make_checked_step`: the debug step (the reference's checkify step):
  the same predicates, evaluated on the device and fetched once a step.
- CFL monitor: warn when dt > cfl_fraction · h / max|v|.
"""

from __future__ import annotations

import numpy as np
import torch

from sph_tpu_torch import neighbors
from sph_tpu_torch.params import Scene, SimParams, scene_from_json, scene_to_json
from sph_tpu_torch.platform import device_const
from sph_tpu_torch.state import State
from sph_tpu_torch.step import make_step

SCALARS = (
    "max_speed",
    "min_rho",
    "mean_rho",
    "max_rho",
    "momentum_x",
    "momentum_y",
    "momentum_z",
    "kinetic_energy",
    "n_active",
)


def scalar_pack(state: State, params: SimParams) -> torch.Tensor:
    """[9] float32 frame diagnostics, computed on the state's device."""
    act = state.active
    w = act.to(torch.float32)
    n_true = torch.sum(w)              # reported count (0 when scene is empty)
    n = torch.clamp(n_true, min=1.0)   # safe divisor for the mean
    speed2 = torch.sum(state.v * state.v, dim=-1)
    max_speed = torch.sqrt(torch.max(torch.where(act, speed2, 0.0)))
    min_rho = torch.min(torch.where(act, state.rho, float("inf")))
    mean_rho = torch.sum(torch.where(act, state.rho, 0.0)) / n
    max_rho = torch.max(torch.where(act, state.rho, float("-inf")))
    mom = params.mass * torch.sum(state.v * w[:, None], dim=0)
    mom3 = torch.cat([mom, mom.new_zeros(3 - mom.shape[0])])
    ke = 0.5 * params.mass * torch.sum(speed2 * w)
    return torch.stack([max_speed, min_rho, mean_rho, max_rho, mom3[0],
                        mom3[1], mom3[2], ke, n_true])


def active_rho_mean(state: State, floor: int = 0) -> float:
    """Mean ρ over the active particles, the divisor at least `floor` (the
    soaks' `rho_mean`)."""
    act = state.active
    return float(torch.sum(torch.where(act, state.rho, 0.0))
                 / max(int(act.sum()), floor))


def active_max_abs_v(state: State) -> float:
    """max |v_k| over the active particles' components (the soaks' and the
    settled maker's max|v|)."""
    return float(torch.where(state.active[:, None], state.v.abs(), 0.0).max())


def scalars_dict(pack) -> dict:
    if isinstance(pack, torch.Tensor):
        pack = pack.detach().cpu().numpy()
    vals = np.asarray(pack, np.float64)
    return dict(zip(SCALARS, vals.tolist()))


def cfl_limit(params: SimParams, max_speed: float, fraction: float = 0.4):
    """Largest stable-ish dt at the observed speed; None if at rest."""
    if max_speed <= 0:
        return None
    return fraction * params.h / max_speed


class Watchdog:
    """Failure detection on fetched frame scalars: raises
    SimulationDiverged when density or speed leaves sane bounds or turns
    NaN, within one frame of the fault."""

    def __init__(self, params: SimParams, rho_factor: float = 100.0,
                 speed_limit: float | None = None):
        self.params = params
        self.rho_factor = rho_factor
        self.speed_limit = speed_limit

    def check(self, pack) -> dict:
        s = scalars_dict(pack)
        if s["n_active"] == 0:
            # a legitimately empty frame (e.g. emitters that start later)
            # yields min_rho=+inf / max_rho=-inf from the masked reductions
            return s
        bad = []
        for k, v in s.items():
            if not np.isfinite(v):
                bad.append(f"{k} is not finite ({v})")
        if s["max_rho"] > self.rho_factor * self.params.rest_density:
            bad.append(f"max_rho {s['max_rho']:.3g} exploded")
        if self.speed_limit and s["max_speed"] > self.speed_limit:
            bad.append(f"max_speed {s['max_speed']:.3g} exploded")
        if bad:
            raise SimulationDiverged("; ".join(bad), scalars=s)
        return s


class SimulationDiverged(RuntimeError):
    def __init__(self, msg, scalars=None):
        super().__init__(msg)
        self.scalars = scalars


# ---------------------------------------------------------------------------
# Checkpoint / resume
# ---------------------------------------------------------------------------

_SCENE_KEY = "__scene_json__"


def save_checkpoint(path: str, state: State, scene: Scene) -> None:
    """State + scene config → one .npz (the state is fetched to the host)."""
    arrays = state.to_numpy()
    arrays[_SCENE_KEY] = np.frombuffer(
        scene_to_json(scene).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, device=None) -> tuple[State, Scene]:
    """→ (state on `device` (None = the card), scene)."""
    with np.load(path) as z:
        scene = scene_from_json(bytes(z[_SCENE_KEY]).decode())
        arrays = {k: z[k] for k in z.files if k != _SCENE_KEY}
    return State.from_numpy(arrays, device), scene


def validate_state(state: State, scene: Scene, slack: float = 4.0) -> list[str]:
    """Host-side sanity sweep: returns a list of problems (empty = healthy)."""
    problems = []
    host = state.to_numpy()
    act = host["emit_step"] <= host["step"]
    x, v, rho = host["x"][act], host["v"][act], host["rho"][act]
    if not np.all(np.isfinite(x)):
        problems.append("non-finite positions")
    if not np.all(np.isfinite(v)):
        problems.append("non-finite velocities")
    if not np.all(np.isfinite(rho)):
        problems.append("non-finite densities")
    lo = np.asarray(scene.lo) - slack * scene.params.h
    hi = np.asarray(scene.hi) + slack * scene.params.h
    if len(x) and (np.any(x < lo[None, :]) or np.any(x > hi[None, :])):
        problems.append("active particles far outside the domain")
    if len(rho) and np.max(rho) > 100.0 * scene.params.rest_density:
        problems.append(f"density blow-up (max {np.max(rho):.3g})")
    return problems


def inject_nan(state: State, k: int = 4) -> State:
    """Fault injection: corrupt the positions of the first k slots with NaN."""
    x = state.x.clone()
    x[:k] = float("nan")
    return state.replace(x=x)


# ---------------------------------------------------------------------------
# Debug checking mode: the checked step
# ---------------------------------------------------------------------------


class CheckFailed(RuntimeError):
    """A predicate of the checked step failed; the message is the
    reference's checkify message."""


def make_checked_step(scene: Scene, method: str = "grid", device=None):
    """Debug-mode step with the reference's four checks (a sanitizer build
    of the step).

    Before the physics (so the report names the state that broke, not its
    NaN-poisoned successor):
      - active positions are finite;
      - active cell indices lie inside the grid *before clipping* (the
        production path clips silently, which is exact physics but hides
        an exploding position until the watchdog bound trips);
      - per-cell occupancy fits the static tile cap (grid/pallas);
    and after: densities came out finite and positive.

    Returns `checked(state) -> state`.  The predicates are reduced on the
    device and fetched together once a step; the first that failed raises
    CheckFailed on the host."""
    grid = None
    if method in ("grid", "pallas"):
        grid = neighbors.GridSpec.for_scene(scene)
    base = make_step(scene, method, grid=grid, device=device)

    def checked(state: State) -> State:
        act = state.active
        dev = state.x.device
        ok = [torch.all(torch.where(act[:, None], torch.isfinite(state.x),
                                    True))]
        over = torch.zeros((), dtype=torch.int64, device=dev)
        if grid is not None:
            lo = device_const(grid.lo, state.x.dtype, dev)
            cell = device_const(grid.cell, state.x.dtype, dev)
            ci_raw = torch.floor((state.x - lo) / cell)
            shape = device_const(grid.shape, state.x.dtype, dev)
            in_bounds = torch.all((ci_raw >= 0) & (ci_raw < shape[None, :]),
                                  dim=-1)
            ok.append(torch.all(torch.where(act, in_bounds, True)))
            over = neighbors.cell_overflow(state.x, act, grid)
        out = base(state)
        rho_ok = torch.where(out.active,
                             torch.isfinite(out.rho) & (out.rho > 0), True)
        ok.append(torch.all(rho_ok))
        vals = torch.stack([*(o.to(torch.int64) for o in ok),
                            over.to(torch.int64)]).tolist()
        if not vals[0]:
            raise CheckFailed("debug: non-finite active position")
        if grid is not None:
            if not vals[1]:
                raise CheckFailed(
                    "debug: active cell index out of grid bounds "
                    "(position escaped the domain)")
            if vals[-1] > 0:
                raise CheckFailed(
                    f"debug: cell tile overflow — {vals[-1]} particles past "
                    f"the static cap would be dropped")
        if not vals[-2]:
            raise CheckFailed("debug: non-finite or non-positive density")
        return out

    return checked
