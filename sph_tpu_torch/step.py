"""One simulation step and the run loop (port of the per-step and the
non-resident address-reuse paths of `sph_tpu/step.py`).

`make_step` builds `step(state) -> state`: density → EOS → forces →
integrate → boundaries.  PyTorch runs eagerly, so `make_advance` is a
Python loop over steps where the reference scans on the device; on the
card a step enqueues its work without a host sync.

Ported so far: `method="naive"`, and `method="pallas"` on the slot layout or
on packed rows (`packed_rows=True`), per step or with Verlet-skin address
reuse (`sort_every > 1`, audited, with an exact re-run).  The options of
the reference that reach beyond that raise NotImplementedError naming the
ROADMAP.md item that brings them.
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np
import torch

from sph_tpu_torch import neighbors, pallas_step, physics
from sph_tpu_torch.params import Scene
from sph_tpu_torch.platform import resolve_device
from sph_tpu_torch.state import State, init

_ROADMAP = "(ROADMAP.md Queue 1 item {})"


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet " + _ROADMAP.format(item))


def _check_slice(scene: Scene, method: str, *, slot_resident: bool = False,
                 adaptive_cap: bool = False, repair_k: int | None = 0,
                 shards=None, row_pair: bool = False, xsub: int = 1) -> None:
    """Raise for every option the port does not have yet."""
    if method == "grid":
        raise _not_ported("method='grid'", 6)
    if method not in ("naive", "pallas"):
        raise ValueError(f"unknown neighbor method {method!r}")
    if slot_resident:
        raise _not_ported(
            "slot_resident (resident blocks, auto-rebuild, heal, and with "
            "them the packed auto policy)", 8)
    if adaptive_cap:
        raise _not_ported("adaptive_cap", 8)
    if repair_k:
        raise _not_ported("repair_k (minority slot repair)", 8)
    if shards:
        raise _not_ported("shards (domain decomposition)", 14)
    if row_pair:
        raise _not_ported("row_pair", 15)
    if xsub > 1:
        raise _not_ported("xsub > 1", 15)
    if scene.params.precision == "bf16":
        raise _not_ported("precision='bf16'", 15)


def _check_packed(scene: Scene, method: str, *, xsub: int = 1,
                  row_pair: bool = False, repair_k: int | None = 0) -> None:
    """The reference's gates on `packed_rows=True`."""
    if method != "pallas":
        raise ValueError("packed_rows requires method='pallas'")
    if xsub != 1 or row_pair:
        raise ValueError(
            "packed_rows does not compose with xsub, row_pair, or "
            "packed_scatter"
        )
    if scene.params.precision == "bf16":
        raise ValueError("packed_rows requires fp32 features")
    if repair_k:
        raise ValueError(
            "packed_rows does not support minority slot repair "
            "(repair re-homing is per-cell-slot addressing)"
        )


def _rho_p_f(x, v, active, scene: Scene, method: str, grid=None, step=None,
             addr=None, packed_rows: bool = False, row_lanes=None):
    """Density → EOS → pairwise forces + gravity + wall penalty + external
    force fields, one x eval.  Returns (rho, p, f); `addr` (pallas only)
    reuses a prebuilt slot addressing (sort_every Verlet-skin reuse)."""
    params = scene.params
    if method == "naive":
        rho = physics.density_naive(x, active, params)
        p = physics.eos_pressure(rho, params)
        f = physics.forces_naive(x, v, rho, p, active, params)
    else:
        # batch_skip of the reference changes scheduling only, never
        # per-particle results; the CUDA kernels skip empty slots anyway
        rho, p, f = pallas_step.pallas_rho_p_f(
            x, v, active, params, grid, addr=addr, packed_rows=packed_rows,
            row_lanes=row_lanes,
        )
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
    scene: Scene, method: str = "naive", grid=None, with_addr: bool = False,
    row_pair: bool = False, packed_rows: bool = False, row_lanes=None,
    device=None,
) -> Callable[..., State]:
    """Build the step function for `scene` on `device` (None = the card).

    method: "naive" (O(N²)) | "pallas" (slot layout with kernels K1/K2, or
    packed rows with K3/K4 when `packed_rows`).
    `grid` overrides the default GridSpec (cap tuning, skinned cells).
    with_addr (pallas only): the returned function is
    `step(state, addr) -> state`, reusing a prebuilt SlotAddr (sort_every).
    """
    xsub = grid.xsub if grid is not None else 1
    if packed_rows:
        _check_packed(scene, method, xsub=xsub, row_pair=row_pair)
    _check_slice(scene, method, row_pair=row_pair, xsub=xsub)
    if with_addr and method != "pallas":
        raise ValueError("with_addr requires method='pallas'")
    dev = resolve_device(device)
    params = scene.params
    dt = params.dt
    grid = _grid_for(scene, method, grid)
    if params.integrator not in ("leapfrog", "euler"):
        raise ValueError(f"unknown integrator {params.integrator!r}")

    def step_impl(state: State, addr=None) -> State:
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
                                 step=state.step, addr=addr,
                                 packed_rows=packed_rows, row_lanes=row_lanes)
            a = f / torch.clamp(rho, min=1e-12)[:, None]
            v = v + (0.5 * dt) * a * mov
        else:
            # Semi-implicit (symplectic) Euler: v += dt f/ρ; x += dt v.
            rho, p, f = _rho_p_f(x, v, active, scene, method, grid,
                                 step=state.step, addr=addr,
                                 packed_rows=packed_rows, row_lanes=row_lanes)
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


def default_skin(scene: Scene, sort_every: int) -> float:
    """Default Verlet-skin width for `sort_every`-step addr reuse: covers a
    particle moving at the EOS sound speed for the whole reuse window
    (WCSPH sizes c₀ ≥ ~10× the expected flow speed, so this is a
    conservative bound; the advance loop still counts actual violations).

    Emitter scenes get a wider skin (×3 or ×2 where h still dominates the
    cell): jets keep the flow permanently near the drift budget — fresh
    near-sonic particles arrive forever, unlike a splash's transient
    impact.  The h/2 bound keeps the widened cell h-dominated, and the
    occupancy bound keeps the rest lattice within the standard cap-16 slot
    grid; exactness is audit-guaranteed at any skin."""
    base = 2.0 * sort_every * scene.params.dt * scene.params.sound_speed
    if scene.emitters:
        h = scene.params.h
        spacing = scene.spacing or h * 0.55
        for mult in (3.0, 2.0):
            skin = mult * base
            occ = ((h + skin) / spacing) ** scene.params.dim
            if skin <= 0.5 * h and occ <= 12.8:
                return skin
    return base


def make_advance(
    scene: Scene, method: str = "naive", steps_per_dispatch: int = 100,
    grid=None, sort_every: int = 1, skin: float | None = None,
    slot_resident: bool = False, xsub: int = 1, row_pair: bool = False,
    membership_audit: bool = True, repair_k: int = 0,
    packed_rows: bool = False, row_lanes: int | None = None, device=None,
):
    """`advance(state) -> state` running `steps_per_dispatch` steps.

    sort_every > 1 (pallas): Verlet-skin addr reuse — the returned advance
    is `advance(state) -> (state, skin_violation_count)`, the count a 0-d
    tensor on the state's device.  The slot addressing is built every
    `sort_every` steps from cells of edge h + skin, and fresh positions are
    scattered into the cached slots each step.  Exact while every particle
    moves < skin/2 within the reuse window; the count reports the particles
    dropped by the static caps at build time plus those that drifted past
    skin/2 (and, with `membership_audit`, also left their build cell), so
    callers can re-run (`make_audited_advance` does).  Mid-window emitter
    activations stay out of pair physics until the next build.

    The reference's 100-step clamp for Pallas dispatches is a TPU worker
    limit and is not carried over."""
    if packed_rows:
        _check_packed(scene, method, xsub=xsub, row_pair=row_pair,
                      repair_k=repair_k)
    _check_slice(scene, method, slot_resident=slot_resident, xsub=xsub,
                 row_pair=row_pair, repair_k=repair_k)
    if sort_every <= 1:
        step = make_step(scene, method, grid=grid, packed_rows=packed_rows,
                         row_lanes=row_lanes, device=device)

        def advance(state: State) -> State:
            for _ in range(steps_per_dispatch):
                state = step(state)
            return state

        return advance

    if method != "pallas":
        raise ValueError("sort_every > 1 requires method='pallas'")
    if grid is not None and skin is None:
        # the audit's drift bound must describe the grid actually used: a
        # caller-supplied grid carries its skin as cell − h
        skin = grid.cell - scene.params.h
        if skin <= 0:
            raise ValueError(
                "sort_every > 1 with a caller-supplied grid requires "
                "skinned cells (GridSpec.for_scene(..., skin=...)); "
                f"got cell == {grid.cell} for h == {scene.params.h} — "
                "addr reuse would be exact only at zero drift"
            )
    if skin is None:
        skin = default_skin(scene, sort_every)
    if grid is None:
        base = neighbors.GridSpec.for_scene(scene)
        grid = neighbors.GridSpec.for_scene(scene, cap=base.cap, skin=skin)
    if packed_rows:
        sg = pallas_step.packed_grid(grid, row_lanes)
    else:
        sg = pallas_step.slot_grid(grid)
    blocks, rem = divmod(steps_per_dispatch, sort_every)
    if rem:
        raise ValueError(
            f"steps_per_dispatch={steps_per_dispatch} must be a "
            f"multiple of sort_every={sort_every}"
        )
    step_a = make_step(scene, "pallas", grid=grid, with_addr=True,
                       packed_rows=packed_rows, row_lanes=row_lanes,
                       device=device)
    half2 = (0.5 * skin) ** 2

    def advance_reuse(state: State):
        viol = torch.zeros((), dtype=torch.int32, device=state.x.device)
        for _ in range(blocks):
            x0, act0 = state.x, state.active
            addr = pallas_step.build_addr(x0, act0, grid, sg)
            # fold build-time cap overflow in with the skin violations: both
            # mean silently-degraded physics
            viol = viol + addr.overflow
            if membership_audit:
                _, flat0 = neighbors.cell_index(x0, act0, grid)
            for _ in range(sort_every):
                state = step_a(state, addr)
                d = state.x - x0
                bad = (torch.sum(d * d, dim=1) > half2) & act0
                if membership_audit:
                    # drift past skin/2 only degrades physics once the
                    # particle also bins outside its build cell
                    _, flat_i = neighbors.cell_index(state.x, act0, grid)
                    bad = bad & (flat_i != flat0)
                viol = viol + torch.sum(bad, dtype=torch.int32)
        return state, viol

    return advance_reuse


#: Occupancy ceiling of the packed-row policy: the packed layout is for
#: states whose mean cell occupancy is at most this (`packed_fits`).
PACKED_MAX_OCC = 3.5


def packed_fits(scene: Scene, state: State, sort_every: int = 4,
                row_lanes: int | None = None) -> bool:
    """Host-side occupancy probe for the packed-row policy: True iff `state`
    is sparse enough for the packed layout (mean cell occupancy ≤
    PACKED_MAX_OCC on the skinned lattice of `sort_every`, and the worst
    (z,)y row fits the static row_lanes with 2× headroom).  Fetches the
    state to the host."""
    skin_p = default_skin(scene, sort_every)
    base_g = neighbors.GridSpec.for_scene(scene)
    grid_p = neighbors.GridSpec.for_scene(scene, cap=base_g.cap, skin=skin_p)
    rl_eff = pallas_step.packed_grid(grid_p, row_lanes).row_lanes
    xa = state.x[state.active].detach().cpu().numpy()
    if xa.shape[0] == 0:
        return True
    cell = grid_p.cell
    lo = np.asarray(scene.lo, np.float64)
    ci = np.floor(
        (xa.astype(np.float64) - lo[None, :] + cell) / cell
    ).astype(np.int64)
    mx = ci.max(0) + 2
    key = ci[:, 0]
    for a in range(1, ci.shape[1]):
        key = key * mx[a] + ci[:, a]
    occ = np.bincount(np.unique(key, return_inverse=True)[1])
    rows = np.bincount(np.unique(key // mx[-1], return_inverse=True)[1])
    return (float(occ.mean()) <= PACKED_MAX_OCC
            and int(rows.max()) * 2 <= rl_eff)


def make_audited_advance(
    scene: Scene, method: str, steps_per_dispatch: int,
    sort_every: int = 1, slot_resident: bool = False, xsub: int = 1,
    grid=None, adaptive_cap: bool = False, row_pair: bool = False,
    membership_audit: bool = True, repair_k: int | None = None,
    packed_rows: bool | None = None, row_lanes: int | None = None,
    device=None,
) -> Callable[[State], State]:
    """`advance(state) -> state` with the reuse path's safety policy built
    in: when the skin/cap audit of a `sort_every > 1` dispatch fires, the
    whole dispatch is re-run from its held input state on the per-step
    path — fast when the skin bound holds, exact when not, never silently
    degraded.  The violation count is fetched once per dispatch.  For
    sort_every <= 1 this is just `make_advance`.

    `packed_rows=None` resolves to False: the reference's occupancy-probing
    packed policy belongs to its slot-resident path, which is not ported
    yet."""
    _check_slice(scene, method, slot_resident=slot_resident,
                 adaptive_cap=adaptive_cap, repair_k=repair_k, xsub=xsub,
                 row_pair=row_pair)
    packed_rows = bool(packed_rows)
    adv = make_advance(scene, method, steps_per_dispatch, grid=grid,
                       sort_every=sort_every, xsub=xsub, row_pair=row_pair,
                       membership_audit=membership_audit,
                       packed_rows=packed_rows, row_lanes=row_lanes,
                       device=device)
    if sort_every <= 1:
        return adv

    exact = []  # per-step-rebuild fallback, made at first use

    def audited(st: State) -> State:
        st2, viol = adv(st)
        n_viol = int(viol)
        if n_viol:
            if not exact:
                exact.append(make_advance(scene, method, steps_per_dispatch,
                                          device=device))
            print(
                f"sph_tpu_torch: {n_viol} skin/cap violations in a "
                f"{steps_per_dispatch}-step dispatch at step "
                f"{int(st.step)} — re-ran exactly (per-step rebuild)",
                file=sys.stderr,
            )
            return exact[0](st)
        return st2

    return audited


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
    membership_audit: bool = True,
    repair_k: int | None = None,
    packed_rows: bool | None = None,
    device=None,
) -> State:
    """Top-level loop: seed (unless `state` is given), prime leapfrog at
    step 0, then advance `n_steps` in dispatches of `steps_per_dispatch`,
    calling `frame_callback` after each.

    sort_every > 1 (pallas): Verlet-skin addr reuse with exact fallback —
    see make_audited_advance; `steps_per_dispatch` is rounded down to a
    multiple of `sort_every`, and a remainder that is no multiple runs per
    step.  packed_rows: True runs the packed-row layout (K3/K4); None and
    False the slot layout."""
    _check_slice(scene, method, slot_resident=slot_resident,
                 adaptive_cap=adaptive_cap, repair_k=repair_k, shards=shards)
    dev = resolve_device(device)
    if state is None:
        state = init(scene, device=dev)
    if scene.params.integrator == "leapfrog" and int(state.step) == 0:
        state = prime(scene, state, method=method, device=dev)
    if sort_every > 1:
        steps_per_dispatch -= steps_per_dispatch % sort_every
        steps_per_dispatch = max(steps_per_dispatch, sort_every)
    n_disp, rem = divmod(n_steps, steps_per_dispatch)
    kw = dict(membership_audit=membership_audit, packed_rows=packed_rows,
              device=dev)
    advance = make_audited_advance(scene, method, steps_per_dispatch,
                                   sort_every=sort_every, **kw)
    for _ in range(n_disp):
        state = advance(state)
        if frame_callback is not None:
            frame_callback(state)
    if rem:
        rem_reuse = sort_every if rem % sort_every == 0 else 1
        state = make_audited_advance(scene, method, rem,
                                     sort_every=rem_reuse, **kw)(state)
        if frame_callback is not None:
            frame_callback(state)
    return state
