"""One simulation step and the run loop (port of the per-step path of
`sph_tpu/step.py`).

`make_step` builds `step(state) -> state`: density → EOS → forces →
integrate → boundaries.  PyTorch runs eagerly, so `make_advance` is a
Python loop over steps where the reference scans on the device; on the
card a step enqueues its work without a host sync.

This slice runs the per-step path: `method="naive"` and `method="pallas"`
with `sort_every=1`.  The options of the reference that reach beyond it
raise NotImplementedError naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

from typing import Callable

import torch

from sph_tpu_torch import neighbors, pallas_step, physics
from sph_tpu_torch.params import Scene
from sph_tpu_torch.platform import resolve_device
from sph_tpu_torch.state import State, init

_ROADMAP = "(ROADMAP.md Queue 1 item {})"


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet " + _ROADMAP.format(item))


def _check_slice(scene: Scene, method: str, *, sort_every: int = 1,
                 slot_resident: bool = False, adaptive_cap: bool = False,
                 shards=None, packed_rows: bool | None = False,
                 row_pair: bool = False, xsub: int = 1) -> None:
    """Raise for every option outside this slice of the port."""
    if method == "grid":
        raise _not_ported("method='grid'", 6)
    if method not in ("naive", "pallas"):
        raise ValueError(f"unknown neighbor method {method!r}")
    if sort_every > 1:
        raise _not_ported("sort_every > 1 (Verlet-skin address reuse)", 8)
    if slot_resident:
        raise _not_ported("slot_resident", 8)
    if adaptive_cap:
        raise _not_ported("adaptive_cap", 8)
    if shards:
        raise _not_ported("shards (domain decomposition)", 14)
    if packed_rows:
        raise _not_ported("packed_rows=True (with kernels K3/K4)", 10)
    if row_pair:
        raise _not_ported("row_pair", 15)
    if xsub > 1:
        raise _not_ported("xsub > 1", 15)
    if scene.params.precision == "bf16":
        raise _not_ported("precision='bf16'", 15)


def _rho_p_f(x, v, active, scene: Scene, method: str, grid=None, step=None):
    """Density → EOS → pairwise forces + gravity + wall penalty + external
    force fields, one x eval.  Returns (rho, p, f)."""
    params = scene.params
    if method == "naive":
        rho = physics.density_naive(x, active, params)
        p = physics.eos_pressure(rho, params)
        f = physics.forces_naive(x, v, rho, p, active, params)
    else:
        # batch_skip of the reference changes scheduling only, never
        # per-particle results; the CUDA kernels skip empty slots anyway
        rho, p, f = pallas_step.pallas_rho_p_f(x, v, active, params, grid)
    f = f + physics.gravity_force(rho, params)
    if params.boundary_mode == "penalty":
        f = f + physics.wall_penalty_force(x, v, scene.lo, scene.hi, params)
    if scene.force_fields and step is not None:
        f = f + physics.force_field_force(x, step, scene.force_fields)
    return rho, p, f


def _grid_for(scene: Scene, method: str, grid):
    if grid is None and method == "pallas":
        grid = neighbors.GridSpec.for_scene(scene)
    return grid


def _on(state: State, dev: torch.device) -> None:
    if state.x.device.type != dev.type:
        raise ValueError(
            f"state lives on {state.x.device}, the step was built for {dev}"
        )


def make_step(
    scene: Scene, method: str = "naive", grid=None, row_pair: bool = False,
    packed_rows: bool = False, device=None,
) -> Callable[[State], State]:
    """Build the step function for `scene` on `device` (None = the card).

    method: "naive" (O(N²)) | "pallas" (slot layout, kernels K1/K2).
    `grid` overrides the default GridSpec (cap tuning).
    """
    _check_slice(scene, method, packed_rows=packed_rows, row_pair=row_pair,
                 xsub=grid.xsub if grid is not None else 1)
    dev = resolve_device(device)
    params = scene.params
    dt = params.dt
    grid = _grid_for(scene, method, grid)
    if params.integrator not in ("leapfrog", "euler"):
        raise ValueError(f"unknown integrator {params.integrator!r}")

    def step_impl(state: State) -> State:
        _on(state, dev)
        active = state.active
        movable = active & (state.kind == 0)
        mov = movable[:, None].to(state.x.dtype)
        x, v, acc = state.x, state.v, state.acc

        if params.integrator == "leapfrog":
            # KDK with stored acceleration: one force eval per step.
            v = v + (0.5 * dt) * acc * mov
            x = x + dt * v * mov
            rho, p, f = _rho_p_f(x, v, active, scene, method, grid,
                                 step=state.step)
            a = f / torch.clamp(rho, min=1e-12)[:, None]
            v = v + (0.5 * dt) * a * mov
        else:
            # Semi-implicit (symplectic) Euler: v += dt f/ρ; x += dt v.
            rho, p, f = _rho_p_f(x, v, active, scene, method, grid,
                                 step=state.step)
            a = f / torch.clamp(rho, min=1e-12)[:, None]
            v = v + dt * a * mov
            x = x + dt * v * mov
        acc = torch.where(movable[:, None], a, 0.0)

        if params.boundary_mode == "clamp":
            xc, vc = physics.clamp_boundary(x, v, scene.lo, scene.hi, params)
            x = torch.where(movable[:, None], xc, x)
            v = torch.where(movable[:, None], vc, v)

        return State(
            x=x,
            v=v,
            acc=acc,
            rho=torch.where(active, rho, state.rho),
            p=torch.where(active, p, state.p),
            kind=state.kind,
            emit_step=state.emit_step,
            step=state.step + 1,
        )

    return step_impl


def prime(scene: Scene, state: State, method: str = "naive",
          device=None) -> State:
    """Fill `state.acc` (and rho/p) from the current positions.

    Leapfrog KDK needs a valid acceleration *before* its first half-kick; a
    cold start from acc = 0 shifts the trajectory by half a step.  `run`
    calls this automatically at step 0.
    """
    _check_slice(scene, method)
    _on(state, resolve_device(device))
    grid = _grid_for(scene, method, None)
    active = state.active
    movable = active & (state.kind == 0)
    rho, p, f = _rho_p_f(state.x, state.v, active, scene, method, grid,
                         step=state.step)
    a = f / torch.clamp(rho, min=1e-12)[:, None]
    return state.replace(
        acc=torch.where(movable[:, None], a, 0.0),
        rho=torch.where(active, rho, state.rho),
        p=torch.where(active, p, state.p),
    )


def make_advance(
    scene: Scene, method: str = "naive", steps_per_dispatch: int = 100,
    grid=None, sort_every: int = 1, slot_resident: bool = False,
    xsub: int = 1, row_pair: bool = False, packed_rows: bool = False,
    device=None,
) -> Callable[[State], State]:
    """`advance(state) -> state` running `steps_per_dispatch` steps.

    The reference's 100-step clamp for Pallas dispatches is a TPU worker
    limit and is not carried over."""
    _check_slice(scene, method, sort_every=sort_every,
                 slot_resident=slot_resident, xsub=xsub, row_pair=row_pair,
                 packed_rows=packed_rows)
    step = make_step(scene, method, grid=grid, device=device)

    def advance(state: State) -> State:
        for _ in range(steps_per_dispatch):
            state = step(state)
        return state

    return advance


def run(
    scene: Scene,
    n_steps: int,
    method: str = "naive",
    steps_per_dispatch: int = 100,
    state: State | None = None,
    frame_callback: Callable[[State], None] | None = None,
    sort_every: int = 1,
    slot_resident: bool = False,
    adaptive_cap: bool = False,
    shards: int | tuple[int, ...] | None = None,
    packed_rows: bool | None = None,
    device=None,
) -> State:
    """Top-level loop: seed (unless `state` is given), prime leapfrog at
    step 0, then advance `n_steps` in dispatches of `steps_per_dispatch`,
    calling `frame_callback` after each."""
    _check_slice(scene, method, sort_every=sort_every,
                 slot_resident=slot_resident, adaptive_cap=adaptive_cap,
                 shards=shards, packed_rows=packed_rows)
    dev = resolve_device(device)
    if state is None:
        state = init(scene, device=dev)
    if scene.params.integrator == "leapfrog" and int(state.step) == 0:
        state = prime(scene, state, method=method, device=dev)
    n_disp, rem = divmod(n_steps, steps_per_dispatch)
    plan = [steps_per_dispatch] * n_disp + ([rem] if rem else [])
    advances = {n: make_advance(scene, method, steps_per_dispatch=n, device=dev)
                for n in set(plan)}
    for n in plan:
        state = advances[n](state)
        if frame_callback is not None:
            frame_callback(state)
    return state
