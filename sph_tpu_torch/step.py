"""One simulation step, the advances and the run loop (port of
`sph_tpu/step.py`).

`make_step` builds `step(state) -> state`: density → EOS → forces →
integrate → boundaries.  PyTorch runs eagerly, so `make_advance` is a
Python loop over steps where the reference scans on the device; on the
card a step enqueues its work without a host sync.

Ported: `method="naive"`, and `method="pallas"` on the slot layout or on
packed rows, per step, with Verlet-skin address reuse (`sort_every > 1`,
audited, with an exact re-run), and slot-resident (`slot_resident=True`):
the classic resident block with or without heal, and the auto-rebuild
resident advance with its membership-relaxed rebuild predicate, heal,
minority slot repair and the packed_scatter transport, under
`make_audited_advance`'s policies (constant-heal demotion, the packed-row
auto policy); each with the kernel options `precision="bf16"`, `xsub` and
`row_pair`.  The reference branches inside its scan with `lax.cond`; here
each such decision is one fetch to the host at a block boundary (`FETCHES`
counts them).  The options of the reference that reach beyond that raise
NotImplementedError naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import numpy as np
import torch

from sph_tpu_torch import neighbors, pallas_step, physics
from sph_tpu_torch.params import Scene
from sph_tpu_torch.platform import device_const, resolve_device
from sph_tpu_torch.slot_kernels import LANE
from sph_tpu_torch.state import State, init

_ROADMAP = "(ROADMAP.md Queue 1 item {})"


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet " + _ROADMAP.format(item))


def _check_slice(method: str, *, adaptive_cap: bool = False,
                 shards=None) -> None:
    """Raise for every option the port does not have yet."""
    if method == "grid":
        raise _not_ported("method='grid'", 6)
    if method not in ("naive", "pallas"):
        raise ValueError(f"unknown neighbor method {method!r}")
    if adaptive_cap:
        raise _not_ported("adaptive_cap (the cap-8 policy)", 16)
    if shards:
        raise _not_ported("shards (domain decomposition)", 14)


def _check_packed(scene: Scene, method: str, *, xsub: int = 1,
                  row_pair: bool = False, repair_k: int | None = 0,
                  packed_scatter: bool = False) -> None:
    """The reference's gates on `packed_rows=True`."""
    if method != "pallas":
        raise ValueError("packed_rows requires method='pallas'")
    if xsub != 1 or row_pair or packed_scatter:
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


#: host fetches made by the resident advances and their audited policies,
#: and the resident blocks run, since the last `reset_fetches()`.  Each
#: decision the reference takes on the device (`lax.cond`) is one fetch
#: here, and a block batches its decisions into as few as the data allows.
FETCHES = {"blocks": 0, "fetches": 0}


def reset_fetches() -> None:
    for k in FETCHES:
        FETCHES[k] = 0


def _fetch(*ts: torch.Tensor) -> list:
    """The values of the device scalars `ts`, in one host round trip."""
    FETCHES["fetches"] += 1
    if len(ts) == 1:
        return [ts[0].item()]
    return torch.stack([t.reshape(()).to(torch.int64) for t in ts]).tolist()


def _rho_p_f(x, v, active, scene: Scene, method: str, grid=None, step=None,
             addr=None, packed_rows: bool = False, row_lanes=None,
             row_pair: bool = False):
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
            row_lanes=row_lanes, row_pair=row_pair,
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
    `grid` overrides the default GridSpec (cap tuning, skinned cells,
    xsub).  with_addr (pallas only): the returned function is
    `step(state, addr) -> state`, reusing a prebuilt SlotAddr (sort_every).
    row_pair (pallas): the reference's two-rows-a-program layout; here it
    only pads c_rows even (`pallas_step.slot_grid`).
    """
    if packed_rows:
        _check_packed(scene, method, row_pair=row_pair,
                      xsub=grid.xsub if grid is not None else 1)
    _check_slice(method)
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
                                 packed_rows=packed_rows, row_lanes=row_lanes,
                                 row_pair=row_pair)
            a = f / torch.clamp(rho, min=1e-12)[:, None]
            v = v + (0.5 * dt) * a * mov
        else:
            # Semi-implicit (symplectic) Euler: v += dt f/ρ; x += dt v.
            rho, p, f = _rho_p_f(x, v, active, scene, method, grid,
                                 step=state.step, addr=addr,
                                 packed_rows=packed_rows, row_lanes=row_lanes,
                                 row_pair=row_pair)
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
    _check_slice(method)
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


# --- Membership-relaxed Verlet audit in slot space --------------------------
#
# With cells of edge h + skin, a pair with |xi − xj| < h stays inside the
# ±1-cell window of the build while each endpoint either still bins into its
# build cell or is within skin/2 of its build position (the reference's
# proof, sph_tpu/step.py:216-235).  So a drift violation is real only once
# the slot has also left its build cell.  Packed rows have no per-lane x
# cell: their windows span whole neighbor rows, so x is membership-exempt
# (its ref is None).  A slot array is [c_rows, C, lanes]; the refs are the
# per-axis build-cell indices of every slot, broadcastable against a
# [c_rows, lanes] plane.  Row 0 and pad rows carry build_addr's safe interior
# code; their slots are masked by `movb` wherever the refs are consumed.


def _slot_bin_refs(addr, sg) -> list:
    """Per-axis BUILD-cell indices of every slot (see above); None for the
    membership-exempt x axis of packed rows."""
    code = addr.row_code
    refs = []
    if sg.dim == 3:
        refs.append((code // sg.h1 - 1)[:, None])    # axis 0 (z): rows
    refs.append(((code % sg.h1 if sg.dim == 3 else code) - 1)[:, None])
    if sg.packed:
        refs.append(None)                             # x unconstrained
    else:
        lane = torch.arange(sg.lanes, dtype=torch.int32, device=code.device)
        refs.append((lane // sg.cap - sg.xc)[None, :])  # x: lanes
    return refs


def _slot_inside_bin(xs, refs, grid):
    """[c_rows, 1, lanes] bool: the slot's CURRENT position still bins into
    its build cell, with `neighbors.cell_index`'s floor and clip, so
    'inside' is exactly 'a rebuild would bin it identically'."""
    cell = device_const(grid.cell, xs.dtype, xs.device)
    ins = None
    for a in range(xs.shape[1]):
        if refs[a] is None:
            continue
        lo = device_const(grid.lo[a], xs.dtype, xs.device)
        ci = torch.floor((xs[:, a, :] - lo) / cell).to(torch.int32)
        ci = torch.clamp(ci, 0, grid.shape[a] - 1)
        eq = ci == refs[a]
        ins = eq if ins is None else ins & eq
    return ins[:, None, :]


def _slot_bin_margin(xs, refs, grid):
    """[c_rows, 1, lanes]: distance to the nearest face of the slot's build
    cell (negative once outside); an exempt axis contributes no face."""
    m = None
    for a in range(xs.shape[1]):
        ref = refs[a]
        if ref is None:
            continue
        lo_c = ref.to(xs.dtype) * grid.cell + grid.lo[a]
        ma = torch.minimum(xs[:, a, :] - lo_c, lo_c + grid.cell - xs[:, a, :])
        m = ma if m is None else torch.minimum(m, ma)
    return m[:, None, :]


def _membership_risky(c, grid, dd2, dt, sort_every, budget):
    """[c_rows, 1, lanes] bool: the rebuild predicate's per-slot AND — the
    next block's 1.2×-projected move can BOTH take the slot out of its
    build cell AND past the drift budget."""
    vs = c["vs"]
    speed = torch.sqrt(torch.sum(vs * vs, dim=1, keepdim=True))
    move = (1.2 * dt * sort_every) * speed
    marg = _slot_bin_margin(c["xs"], c["refs"], grid)
    return c["movb"] & (marg < move) & (torch.sqrt(dd2) + move > budget)


def _membership_bad(bad, xs, refs, grid):
    """Relax a strict drift-audit mask by membership: a violation is real
    only once the slot ALSO left its build cell."""
    return bad & ~_slot_inside_bin(xs, refs, grid)


def make_repair_tools(grid, sg, d, dt, sort_every, budget, repair_k, gather):
    """(plan, apply) for MINORITY SLOT REPAIR (see
    `_make_resident_auto_advance`).  Planned in particle space: `x0_p` holds
    every particle's build anchor (the shadow's x, which the caller advances
    for repaired particles), `c["addr"]` its slot.  The risky test is the
    particle-space mirror of `_membership_risky`, 1.2× projection included.

    JAX's padded `nonzero(size=)` becomes a cumsum rank scattered into a
    buffer with one spare dump entry, and its dropped `.at[].set/add` writes
    go to one spare element past the end of each array, sliced off after."""
    n_codes = sg.h0 * sg.h1
    usable_rows = sg.c_rows - 1
    big = 2**30
    i32, i64 = torch.int32, torch.int64

    def plan(c, x0_p, act0, movable0):
        addr = c["addr"]
        dev = x0_p.device
        cap_n = x0_p.shape[0]
        ok = addr.ok()
        x_now = gather(c["xs"], d, addr)
        v_now = gather(c["vs"], d, addr)
        speed_p = torch.sqrt(torch.sum(v_now * v_now, dim=1))
        move_p = (1.2 * dt * sort_every) * speed_p
        dd = x_now - x0_p
        drift_p = torch.sqrt(torch.sum(dd * dd, dim=1))
        ci0, _ = neighbors.cell_index(x0_p, act0, grid)
        lo = device_const(grid.lo, x0_p.dtype, dev)
        lo_c = lo[None, :] + ci0.to(x0_p.dtype) * grid.cell
        margin_p = torch.amin(
            torch.minimum(x_now - lo_c, lo_c + grid.cell - x_now), dim=1)
        risky = (movable0 & ok & (margin_p < move_p)
                 & (drift_p + move_p > budget))
        n_risky = torch.sum(risky, dtype=i32)
        # nonzero(risky, size=repair_k, fill_value=cap_n)
        k = torch.cumsum(risky, 0) - 1
        pids = torch.full((repair_k + 1,), cap_n, dtype=i64, device=dev)
        pids.index_put_((torch.where(risky & (k < repair_k), k, repair_k),),
                        torch.arange(cap_n, device=dev))
        pids = pids[:repair_k]
        vm = pids < cap_n
        pid_s = torch.clamp(pids, max=cap_n - 1)
        x_m = x_now[pid_s]
        old_row = addr.row_pos[pid_s]
        old_pos = addr.pos[pid_s]

        # target cell of each mover = the bin of its CURRENT position
        ci_m, _ = neighbors.cell_index(x_m, vm, grid)
        if d == 3:
            code_m = (ci_m[:, 0] + 1) * sg.h1 + (ci_m[:, 1] + 1)
        else:
            code_m = ci_m[:, 0] + 1
        hx_m = ci_m[:, -1] + sg.xc

        # code → compacted row (the build's row_inv, rebuilt from addr)
        iu = torch.arange(usable_rows, dtype=i32, device=dev)
        in_range = iu < addr.n_occ[0]
        targets = torch.where(in_range, addr.row_code[1:], n_codes).long()
        row_inv = torch.zeros(n_codes + 1, dtype=i32, device=dev)
        row_inv.index_put_((targets,), torch.where(in_range, 1 + iu, 0))
        new_row = row_inv[torch.clamp(code_m, 0, n_codes).long()]

        # free lanes AFTER evicting the movers (so a same-cell re-home can
        # reuse its own lane); the j-th mover into a cell takes its j-th
        # free lane
        size = sg.c_rows * sg.lanes
        occ = torch.cat([(c["xs"][:, 0, :] < 1e17).reshape(-1),
                         torch.zeros(1, dtype=torch.bool, device=dev)])
        occ.index_put_(
            (torch.where(vm, old_row.long() * sg.lanes + old_pos.long(),
                         size),),
            torch.zeros((), dtype=torch.bool, device=dev))
        occ3 = occ[:size].reshape(sg.c_rows * sg.h2, sg.cap)
        cumfree = torch.cumsum((~occ3).to(i32), dim=1)
        cellkey = new_row * sg.h2 + hx_m
        key = torch.where(vm, cellkey, big)
        order = torch.argsort(key, stable=True)
        ksort = key[order]
        first = torch.searchsorted(ksort, ksort)
        rank = torch.empty(repair_k, dtype=i64, device=dev).scatter_(
            0, order, torch.arange(repair_k, device=dev) - first)
        rowsel = torch.clamp(cellkey, 0, sg.c_rows * sg.h2 - 1).long()
        occ_row = occ3[rowsel]                                  # [K, cap]
        cf_row = cumfree[rowsel]
        onehot = (~occ_row) & (cf_row == (rank + 1)[:, None])
        placeable = torch.any(onehot, dim=1)
        lane_in = torch.argmax(onehot.to(i32), dim=1).to(i32)
        new_pos = hx_m * sg.cap + lane_in

        can = ((n_risky <= repair_k) & (n_risky > 0)
               & ~torch.any(vm & ((new_row == 0) | ~placeable)))
        return dict(can=can, n_risky=n_risky, pids=pids, vm=vm, x_m=x_m,
                    old_row=old_row, old_pos=old_pos,
                    new_row=new_row, new_pos=new_pos)

    def apply(c, plan_d):
        """Patched slot arrays + addr (pure re-addressing: the particle state
        this carry materializes is bitwise unchanged).  Does not touch the
        caller's shadow: the caller advances shadow.x to x_m at the repaired
        pids, or they stay phantom-risky against their old anchors."""
        addr = c["addr"]
        dev = addr.pos.device
        vm = plan_d["vm"]
        old_row, old_pos = plan_d["old_row"].long(), plan_d["old_pos"].long()
        new_row, new_pos = plan_d["new_row"].long(), plan_d["new_pos"].long()

        def idx(arr, row, pos):
            """[ncols·K] flat element indices of the movers' slots in `arr`,
            the spare element `arr.numel()` for the non-movers."""
            ncols = arr.shape[1]
            cols = torch.arange(ncols, device=dev)[:, None]
            flat = (row[None, :] * ncols + cols) * sg.lanes + pos[None, :]
            return torch.where(vm[None, :], flat, arr.numel()).reshape(-1)

        def move(arr, new_vals, old_vals):
            """Per-axis slot move: sentinel the old slots FIRST so a
            same-cell re-home landing on its own lane keeps the value."""
            flat_a = torch.cat([arr.reshape(-1), arr.new_zeros(1)])
            flat_a.index_put_((idx(arr, old_row, old_pos),),
                              old_vals.reshape(-1))
            flat_a.index_put_((idx(arr, new_row, new_pos),),
                              new_vals.reshape(-1))
            return flat_a[:arr.numel()].reshape(arr.shape)

        def take(arr):
            """[ncols, K] values of the movers' old slots."""
            flat = idx(arr, old_row, old_pos)
            flat = torch.where(flat < arr.numel(), flat, 0)
            return arr.reshape(-1)[flat].reshape(arr.shape[1], -1)

        x_cols = plan_d["x_m"].T
        far = torch.full_like(x_cols, 1e18)
        zero = torch.zeros_like(x_cols)
        rp_cols = take(c["rp"])
        xs = move(c["xs"], x_cols, far)
        vs = move(c["vs"], take(c["vs"]), zero)
        acc = move(c["acc"], take(c["acc"]), zero)
        x0s = move(c["x0s"], x_cols, far)
        rp = move(c["rp"], rp_cols, torch.zeros_like(rp_cols))
        movb = move(c["movb"], torch.ones_like(vm)[None, :],
                    torch.zeros_like(vm)[None, :])

        n_g = addr.gcounts.numel()
        gfl = torch.cat([addr.gcounts.reshape(-1),
                         addr.gcounts.new_zeros(1)])
        ones = torch.ones_like(old_row, dtype=i32)
        gfl.index_put_(
            (torch.where(vm, old_row * sg.n_groups + old_pos // LANE, n_g),),
            -ones, accumulate=True)
        gfl.index_put_(
            (torch.where(vm, new_row * sg.n_groups + new_pos // LANE, n_g),),
            ones, accumulate=True)
        n = addr.pos.shape[0]
        sidx = torch.where(vm, plan_d["pids"], n)

        def patch(field, vals):
            ext = torch.cat([field, field.new_zeros(1)])
            ext.index_put_((sidx,), vals.to(field.dtype))
            return ext[:n]

        addr2 = dataclasses.replace(
            addr,
            pos=patch(addr.pos, new_pos),
            row_pos=patch(addr.row_pos, new_row),
            gcounts=gfl[:n_g].reshape(addr.gcounts.shape),
        )
        return {**c, "addr": addr2, "xs": xs, "vs": vs, "acc": acc,
                "x0s": x0s, "rp": rp, "movb": movb}

    return plan, apply


class _SlotPhysics:
    """Elementwise physics in [c_rows, d, lanes] SLOT space — the exact
    per-element arithmetic of physics.gravity_force / wall_penalty_force /
    force_field_force / clamp_boundary, so integrating in slot space is
    bitwise integrating in particle space."""

    def __init__(self, scene: Scene, grid, sg, device: torch.device):
        params = scene.params
        f32 = torch.float32
        self.scene = scene
        self.params = params
        self.grid = grid
        self.sg = sg
        self.d = d = params.dim
        self.g3 = device_const(tuple(params.gravity), f32, device).reshape(
            1, d, 1)
        self.lo_w = (device_const(tuple(scene.lo), f32, device)
                     + params.wall_eps).reshape(1, d, 1)
        self.hi_w = (device_const(tuple(scene.hi), f32, device)
                     - params.wall_eps).reshape(1, d, 1)
        self.fields = [
            (device_const(tuple(ff.pos), f32, device).reshape(1, d, 1), ff)
            for ff in scene.force_fields
        ]

    def body_forces(self, xs, vs, rho_s, f_s, step0, i: int):
        """Gravity, wall penalty and force fields at step `step0 + i`."""
        params = self.params
        f = f_s + rho_s * self.g3
        if params.boundary_mode == "penalty":
            k_w, c_w = params.wall_stiffness, params.wall_damping
            d_lo = torch.clamp(self.lo_w - xs, min=0.0)
            d_hi = torch.clamp(xs - self.hi_w, min=0.0)
            f = f + (k_w * d_lo - c_w * vs) * (d_lo > 0) - (
                k_w * d_hi - c_w * (-vs)
            ) * (d_hi > 0)
        if self.fields:
            step_i = step0 + i
        for c, ff in self.fields:
            dx = c - xs
            r = torch.sqrt(torch.sum(dx * dx, dim=1, keepdim=True))
            fall = torch.clamp(1.0 - r / ff.radius, min=0.0)
            live = ((step_i >= ff.start_step)
                    & (step_i < ff.stop_step)).to(xs.dtype)
            dirn = dx / torch.clamp(r, min=1e-6)
            f = f + (ff.strength * live) * fall * dirn
        return f

    def clamp_slot(self, xs, vs, movb):
        hit = (xs < self.lo_w) | (xs > self.hi_w)
        vs2 = torch.where(hit, vs * self.params.boundary_damping, vs)
        xs2 = torch.minimum(torch.maximum(xs, self.lo_w), self.hi_w)
        return torch.where(movb, xs2, xs), torch.where(movb, vs2, vs)

    def slot_centers(self, addr):
        """[c_rows, d, lanes] fp32 cell centers of every slot, from the
        slot's lane (x slot-cell) and its row's code (z, y cells): the bf16
        cell-relative frame, bitwise `SlotAddr.center` of the particle in
        the slot.  The row code counts the halo, hence − 0.5."""
        grid, sg, d = self.grid, self.sg, self.d
        f32 = torch.float32
        dev = addr.row_code.device
        lo = [device_const(grid.lo[a], f32, dev) for a in range(d)]
        cell = device_const(grid.cell, f32, dev)
        lane = torch.arange(sg.lanes, dtype=torch.int32, device=dev)
        cx = lo[-1] + ((lane // sg.cap - sg.xc).to(f32) + 0.5) * device_const(
            grid.cell / sg.xsub, f32, dev)
        code = addr.row_code
        shape = (sg.c_rows, 1, sg.lanes)
        rows = ([code // sg.h1, code % sg.h1] if d == 3 else [code])
        parts = [(lo[a] + (r.to(f32) - 0.5) * cell)[:, None, None].expand(shape)
                 for a, r in enumerate(rows)]
        return torch.cat(parts + [cx[None, None, :].expand(shape)], dim=1)

    def bf16_feat_builder(self, addr):
        """The kernels' per-step bf16 view of the slot state: positions
        relative to the slot centers, velocities absolute, rounded to bf16
        (the fp32 state itself never leaves fp32)."""
        sg, d = self.sg, self.d
        dev = addr.row_code.device
        centers = self.slot_centers(addr)
        zrow = torch.zeros((sg.c_rows, 3 - d, sg.lanes), device=dev)
        z2 = torch.zeros((sg.c_rows, 2, sg.lanes), device=dev)

        def mk_feat(xs_, vs_):
            return torch.cat([xs_ - centers, zrow, vs_, zrow, z2],
                             dim=1).to(torch.bfloat16)

        return mk_feat

    @staticmethod
    def gather(slot, ncomp: int, addr):
        """[N, ncomp] per-particle values of a [c_rows, C, lanes] slot
        array (particles without a slot read row 0, lane 0; callers mask
        them)."""
        ok = addr.ok()
        row = torch.where(ok, addr.row_pos, 0).long()
        pos = torch.where(ok, addr.pos, 0).long()
        return slot[row, :ncomp, pos]


def _slot_steps(sp: _SlotPhysics, c, sort_every: int, half2: float,
                use_mem: bool, grid, leap: bool, mk_feat):
    """`sort_every` steps integrated in slot space from the carry `c`
    (xs, vs, acc, x0s, movb, addr, ...), with the per-step drift audit.
    Returns (xs, vs, acc, rp, violations) — the count a device scalar.
    The leapfrog block-top kick uses `c["acc"]` (zeros on a fresh carry,
    whose kick was pre-applied in particle space)."""
    params, d = sp.params, sp.d
    dt = params.dt
    addr, sg, movb = c["addr"], sp.sg, c["movb"]
    mov = movb.to(torch.float32)
    xs, vs, acc_s, x0s = c["xs"], c["vs"], c["acc"], c["x0s"]
    step0 = c["step0"]
    jb = c["jb"]
    rp = c["rp"]
    viol = None
    for i in range(sort_every):
        if leap:
            if acc_s is not None:
                vs = vs + (0.5 * dt) * acc_s * mov
            xs = xs + dt * vs * mov
        feat = mk_feat(xs, vs)
        rp = pallas_step._call_density(feat, addr, sg, params, jb)
        f_s = pallas_step._call_force(feat, rp, addr, sg, params, jb)
        rho_s = rp[:, 0:1, :]
        f_tot = sp.body_forces(xs, vs, rho_s, f_s[:, 0:d, :], step0, i)
        a_s = torch.where(movb, f_tot / torch.clamp(rho_s, min=1e-12), 0.0)
        if leap:
            vs = vs + (0.5 * dt) * a_s
        else:
            vs = vs + dt * a_s * mov
            xs = xs + dt * vs * mov
        acc_s = a_s
        if params.boundary_mode == "clamp":
            xs, vs = sp.clamp_slot(xs, vs, movb)
        dd = xs - x0s
        drift2 = torch.sum(dd * dd, dim=1, keepdim=True)
        bad_i = (drift2 > half2) & movb
        if use_mem:
            bad_i = _membership_bad(bad_i, xs, c["refs"], grid)
        n_bad = torch.sum(bad_i, dtype=torch.int32)
        viol = n_bad if viol is None else viol + n_bad
    return xs, vs, acc_s, rp, viol


def _residency(s: State, grid, sg, d: int, dt: float, leap: bool,
               use_mem: bool) -> dict:
    """Particle state → slot residency (build + scatter), the classic
    block-top sequence.  The leapfrog half-kick is pre-applied in particle
    space (bitwise the same elementwise arithmetic), so acc is not
    scattered; the 7 scatter columns are x | v_half | movable."""
    act0 = s.active
    movable0 = act0 & (s.kind == 0)
    addr = pallas_step.build_addr(s.x, act0, grid, sg)
    movf = movable0[:, None].to(torch.float32)
    v_in = s.v + (0.5 * dt) * s.acc * movf if leap else s.v
    zpad = s.x.new_zeros((s.capacity, 3 - d))
    rows = torch.cat([s.x, zpad, v_in, zpad, movf], dim=1)
    feat = pallas_step.scatter_slots(addr, rows, sg)
    xs = feat[:, 0:d, :]
    return dict(
        addr=addr, feat=feat, xs=xs, vs=feat[:, 3:3 + d, :], x0s=xs,
        movb=feat[:, 6:7, :] > 0,
        refs=_slot_bin_refs(addr, sg) if use_mem else None,
        jb=pallas_step._jblocks(addr, sg) if sg.packed else None,
        step0=s.step,
    )


def _materialize(sp: _SlotPhysics, c, s: State, step) -> State:
    """Slots → particle State (non-slotted particles keep the values of
    `s`, the state the residency was entered from)."""
    addr, d, gather = c["addr"], sp.d, sp.gather
    act0 = s.active
    movable0 = act0 & (s.kind == 0)
    ok = addr.ok()
    okc = ok[:, None]
    rho_p = torch.where(ok & act0, gather(c["rp"], 1, addr)[:, 0], s.rho)
    return State(
        x=torch.where(okc, gather(c["xs"], d, addr), s.x),
        v=torch.where(okc, gather(c["vs"], d, addr), s.v),
        acc=torch.where(okc & movable0[:, None], gather(c["acc"], d, addr),
                        s.acc),
        rho=rho_p,
        p=torch.where(ok & act0, physics.eos_pressure(rho_p, sp.params), s.p),
        kind=s.kind,
        emit_step=s.emit_step,
        step=step,
    )


def _make_resident_advance(
    scene: Scene, grid, sg, sort_every: int, blocks: int, skin: float,
    heal: bool = False, membership_audit: bool = True, device=None,
):
    """Slot-resident block advance: the particle state LIVES in the slot
    arrays for `sort_every` steps — integration is elementwise in slot
    space — so the per-step feature scatter, per-particle gathers and the
    sort of the classic path are paid once per block.

    Bitwise-identical to the non-resident sort_every path while no static
    cap overflows (integration is elementwise and the kernels see identical
    inputs).  At the degradation edges: cap/row-overflow particles freeze
    for the block (they are not in slots), and mid-block emitter
    activations freeze until the next block top.

    heal=True — per-block exact fallback: each block audits its own skin
    drift and build-time cap overflow, and a violating block is re-run from
    its held input state on the per-step path (`make_step` on the default
    grid), one host fetch of the block's count deciding it.  The returned
    advance is then `advance(state) -> (state, residual_viol, healed)`,
    residual_viol a device zero and healed a host int; else
    `advance(state) -> (state, viol)`, viol a device scalar."""
    params = scene.params
    dt = params.dt
    d = params.dim
    half2 = (0.5 * skin) ** 2
    use_mem = membership_audit and sg.xsub == 1
    leap = params.integrator == "leapfrog"
    dev = resolve_device(device)
    sp = _SlotPhysics(scene, grid, sg, dev)
    if heal:
        # exact per-step rebuild on the DEFAULT bare grid: identical to the
        # plain `method="pallas"` path, so a healed block is bitwise it
        exact_step = make_step(scene, "pallas", device=dev)

    def advance(state: State):
        _on(state, dev)
        s = state
        viol = torch.zeros((), dtype=torch.int32, device=s.x.device)
        healed = 0
        for _ in range(blocks):
            FETCHES["blocks"] += 1
            c = _residency(s, grid, sg, d, dt, leap, use_mem)
            if params.precision == "bf16":
                mk_feat = sp.bf16_feat_builder(c["addr"])
            else:
                feat0 = c["feat"]
                pad = feat0[:, d:3, :] * 0.0
                tail = feat0[:, 6:, :]

                def mk_feat(xs_, vs_):  # pad + flag columns never change
                    return torch.cat([xs_, pad, vs_, pad, tail], dim=1)

            c.update(acc=None, rp=None)
            xs, vs, a_s, rp, viol_blk = _slot_steps(
                sp, c, sort_every, half2, use_mem, grid, leap, mk_feat)
            viol_blk = viol_blk + c["addr"].overflow
            c.update(xs=xs, vs=vs, acc=a_s, rp=rp)
            out = _materialize(sp, c, s, s.step + sort_every)
            if heal:
                if _fetch(viol_blk > 0)[0]:
                    for _ in range(sort_every):
                        s = exact_step(s)
                    healed += 1
                    continue
            else:
                viol = viol + viol_blk
            s = out
        if heal:
            return s, viol, healed
        return s, viol

    return advance


def _make_resident_auto_advance(
    scene: Scene, grid, sg, sort_every: int, blocks: int, skin: float,
    rebuild_frac: float = 1.0, reactive_theta: float | None = None,
    membership_audit: bool = True, repair_k: int = 0,
    packed_scatter: bool = False, device=None,
):
    """AUTO-REBUILD slot-resident advance: the state stays in the slot
    arrays ACROSS block boundaries, and the build_addr + scatter +
    materialize rebuild runs only when needed — when the drift budget is
    about to be spent, or an emitter activated since the last build.

    The `need` predicate, checked at every block top, has three forms:
      - `reactive_theta` (a test knob): the MEASURED max drift crosses
        `reactive_theta · skin/2`, with no projection;
      - the membership predicate (default): some slot's 1.2×-projected
        move can both take it out of its build cell and past the budget
        `rebuild_frac · skin/2` (`_membership_risky`);
      - with `membership_audit=False`: max drift + 1.2 · max|v| · dt ·
        sort_every crosses the budget.
    `rebuild_frac=0` forces a rebuild at every moving block (a test knob).

    Exactness: the per-step audit checks cumulative drift against skin/2
    from the LAST build (membership-relaxed), and a violating block is
    HEALED — re-run from its held slot top with the exact per-step path,
    then re-entered fresh.

    repair_k > 0: MINORITY SLOT REPAIR — when the predicate fires on at most
    repair_k risky particles, re-home just those into free slots of the
    cells their current positions bin into, inside the existing addressing
    (`make_repair_tools`), instead of a full rebuild; it falls back to the
    rebuild when an emitter activated or it cannot re-home exactly.

    packed_scatter: a rebuild transports x (relative to the build-time
    cell centers) and v as bf16 pairs packed into fp32-typed columns
    (`pallas_step.pack2bf16`, `scatter_slots_packed`), 4 scatter columns
    in 3D instead of 7, unpacked right after; the kernels stay fp32 and
    each rebuild costs one bf16 round trip of x and v.

    The reference decides each block inside its scan with `lax.cond`; here
    the decisions are fetched to the host, batched: the next block's `need`
    is computed on the un-healed carry beside this block's audit count and
    the pair fetched once, recomputed only after a heal; a repair's
    feasibility is one more fetch, on the blocks that need a fix.

    Returns `advance(state) -> (state, residual_viol, healed, rebuilds)`,
    plus a trailing `repairs` when repair_k > 0: residual_viol is a device
    zero (every violating block heals), the counters host ints."""
    params = scene.params
    dt = params.dt
    d = params.dim
    half2 = (0.5 * skin) ** 2
    use_mem = membership_audit and sg.xsub == 1
    budget = rebuild_frac * 0.5 * skin if rebuild_frac > 0 else 0.0
    leap = params.integrator == "leapfrog"
    if repair_k:
        if not use_mem:
            raise ValueError(
                "repair_k requires membership_audit=True and xsub == 1"
            )
        if params.precision == "bf16":
            raise ValueError("repair_k does not support precision='bf16'")
        if reactive_theta is not None or rebuild_frac <= 0:
            raise ValueError(
                "repair_k composes with the membership predicate only "
                "(reactive_theta=None, rebuild_frac > 0)"
            )
    dev = resolve_device(device)
    sp = _SlotPhysics(scene, grid, sg, dev)
    exact_step = make_step(scene, "pallas", device=dev)  # heal: bare grid
    zrow = torch.zeros((sg.c_rows, 3 - d, sg.lanes), device=dev)
    if packed_scatter:
        # background: x halves unpack far (≈ the 1e18 empty sentinel), v
        # and the movable flag 0
        far, zero = (torch.full((), a, device=dev) for a in (1e18, 0.0))
        bg_halves = [far] * d + [zero] * d
        bg_row = torch.stack(
            [pallas_step.pack2bf16(bg_halves[2 * i], bg_halves[2 * i + 1])
             for i in range(d)] + [zero])

    def residency_packed(s: State) -> dict:
        """`_residency` through the packed-bf16 transport: x relative to
        the build-time cell centers and v travel as bf16 pairs, and the
        slot arrays are unpacked to fp32 (x back on the slot centers)."""
        act0 = s.active
        movable0 = act0 & (s.kind == 0)
        addr = pallas_step.build_addr(s.x, act0, grid, sg)
        movf = movable0[:, None].to(torch.float32)
        v_in = s.v + (0.5 * dt) * s.acc * movf if leap else s.v
        xr = s.x - addr.center
        halves = [xr[:, i] for i in range(d)] + [v_in[:, i] for i in range(d)]
        cols = [pallas_step.pack2bf16(halves[2 * i], halves[2 * i + 1])
                for i in range(d)] + [movf[:, 0]]
        packed = pallas_step.scatter_slots_packed(
            addr, torch.stack(cols, dim=1), sg, bg_row)
        flat = [h for i in range(d)
                for h in pallas_step.unpack2bf16(packed[:, i, :])]
        xs = torch.stack(flat[:d], dim=1) + sp.slot_centers(addr)
        return dict(
            addr=addr, xs=xs, vs=torch.stack(flat[d:], dim=1), x0s=xs,
            movb=packed[:, d:d + 1, :] > 0,
            refs=_slot_bin_refs(addr, sg) if use_mem else None,
            jb=None, step0=s.step,
        )

    def enter_slots(s: State) -> dict:
        """Residency of `s`; acc/rho/p are not scattered — the first
        block's kick is pre-applied and its density pass overwrites rp —
        and until a block has run (`live`) the shadow `s` is the source of
        truth for them."""
        if packed_scatter:
            c = residency_packed(s)
        else:
            c = _residency(s, grid, sg, d, dt, leap, use_mem)
            del c["feat"]
        c.update(acc=torch.zeros_like(c["xs"]),
                 rp=c["xs"].new_zeros((sg.c_rows, 2, sg.lanes)),
                 shadow=s, build_step=s.step, pend_over=c["addr"].overflow,
                 live=False)
        return c

    def materialize(c) -> State:
        s = c["shadow"]
        if not c["live"]:
            return s
        return _materialize(sp, c, s, s.step)

    def mk_feat_for(c):
        """The kernels' per-step feature view of the carry's xs/vs (the
        pad and flag columns are fixed for the block); bf16: relative to
        the slot centers of the carry's addressing."""
        if params.precision == "bf16":
            return sp.bf16_feat_builder(c["addr"])
        mov = c["movb"].to(torch.float32)
        tail = torch.cat([mov, torch.zeros_like(mov)], dim=1)

        def mk_feat(xs_, vs_):
            return torch.cat([xs_, zrow, vs_, zrow, tail], dim=1)

        return mk_feat

    def need_of(c):
        """(need, activated) device bools of the block that starts from `c`."""
        s = c["shadow"]
        dd = c["xs"] - c["x0s"]
        dd2 = torch.sum(dd * dd, dim=1, keepdim=True)
        activated = torch.any((s.emit_step > c["build_step"])
                              & (s.emit_step <= s.step))
        if reactive_theta is not None:
            drift_now = torch.sqrt(torch.amax(dd2))
            need = (drift_now > reactive_theta * 0.5 * skin) | activated
        elif use_mem and rebuild_frac > 0:
            risky = _membership_risky(c, grid, dd2, dt, sort_every, budget)
            need = torch.any(risky) | activated
        else:
            drift_now = torch.sqrt(torch.amax(dd2))
            vmax = torch.sqrt(torch.amax(torch.sum(c["vs"] * c["vs"], dim=1)))
            predicted = drift_now + 1.2 * vmax * dt * sort_every
            need = (predicted > budget) | activated
        return need, activated

    def rebuild(c):
        return enter_slots(materialize(c))

    if repair_k:
        plan_t, apply_t = make_repair_tools(
            grid, sg, d, dt, sort_every, budget, repair_k, sp.gather)

        def plan_repair(c):
            s = c["shadow"]
            act0 = s.active
            return plan_t(c, s.x, act0, act0 & (s.kind == 0))

        def apply_repair(c, plan):
            c2 = apply_t(c, plan)
            # advance the repaired particles' plan anchors (shadow.x is x0
            # in plan_repair), else they stay phantom-risky against their
            # OLD cell; materialize and heal read shadow.x only for
            # non-slotted or pre-live particles
            sh = c["shadow"]
            n = sh.x.shape[0]
            sidx = torch.where(plan["vm"], plan["pids"], n)
            x_ext = torch.cat([sh.x, sh.x.new_zeros((1, d))])
            x_ext.index_put_((sidx,), plan["x_m"])
            return {**c2, "shadow": sh.replace(x=x_ext[:n])}

    def advance(state: State):
        _on(state, dev)
        c = enter_slots(state)
        healed, rebuilds, repairs = 0, 1, 0
        need_t, act_t = need_of(c)
        (need,) = _fetch(need_t)
        for b in range(blocks):
            FETCHES["blocks"] += 1
            more = b + 1 < blocks
            if need:
                if repair_k:
                    plan = plan_repair(c)
                    if _fetch(plan["can"] & ~act_t)[0]:
                        c = apply_repair(c, plan)
                        repairs += 1
                    else:
                        c = rebuild(c)
                        rebuilds += 1
                else:
                    c = rebuild(c)
                    rebuilds += 1
            c["step0"] = c["shadow"].step
            xs, vs, acc_s, rp, viol_blk = _slot_steps(
                sp, c, sort_every, half2, use_mem, grid, leap, mk_feat_for(c))
            if c["pend_over"] is not None:
                viol_blk = viol_blk + c["pend_over"]
            ok_carry = {
                **c, "xs": xs, "vs": vs, "acc": acc_s, "rp": rp,
                "shadow": c["shadow"].replace(
                    step=c["shadow"].step + sort_every),
                "pend_over": None,
                "live": True,   # slot acc/rp real from now on
            }
            if more:
                need_t, act_t = need_of(ok_carry)
                bad, need = _fetch(viol_blk > 0, need_t)
            else:
                (bad,) = _fetch(viol_blk > 0)
            if bad:
                # exact per-step re-run of this block from its held slot
                # top, then fresh residency (bitwise the classic path)
                sm = materialize(c)
                for _ in range(sort_every):
                    sm = exact_step(sm)
                c = enter_slots(sm)
                healed += 1
                rebuilds += 1
                if more:
                    need_t, act_t = need_of(c)
                    (need,) = _fetch(need_t)
            else:
                c = ok_carry
        viol = torch.zeros((), dtype=torch.int32, device=state.x.device)
        out = (materialize(c), viol, healed, rebuilds)
        if repair_k:
            out = out + (repairs,)
        return out

    return advance


def make_advance(
    scene: Scene, method: str = "naive", steps_per_dispatch: int = 100,
    grid=None, sort_every: int = 1, skin: float | None = None,
    slot_resident: bool = False, xsub: int = 1, heal: bool = False,
    row_pair: bool = False, auto_rebuild: bool = False,
    rebuild_frac: float = 1.0, reactive_theta: float | None = None,
    membership_audit: bool = True, repair_k: int = 0,
    packed_scatter: bool = False, packed_rows: bool = False,
    row_lanes: int | None = None, device=None,
):
    """`advance(state) -> state` running `steps_per_dispatch` steps.

    xsub > 1 (pallas, no `grid` given): the slot layout subdivides each x
    cell into xsub slot-cells (`GridSpec.for_scene(xsub=)`); the audits then
    fall back to the strict drift test, as in the reference.  row_pair: see
    `make_step`.

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

    slot_resident (pallas, sort_every > 1): integrate IN slot space
    (`_make_resident_advance`; with `heal` it returns (state, residual_viol,
    healed)); with `auto_rebuild` also across block boundaries
    (`_make_resident_auto_advance`, which returns (state, residual_viol,
    healed, rebuilds[, repairs])).

    The reference's 100-step clamp for Pallas dispatches is a TPU worker
    limit and is not carried over; its `batch_skip` grid flag for emitter
    scenes changes scheduling only, and the port's kernels skip empty slots
    anyway."""
    if slot_resident and sort_every <= 1:
        raise ValueError("slot_resident requires sort_every > 1")
    if heal and not slot_resident:
        raise ValueError("heal requires slot_resident=True")
    if auto_rebuild and not slot_resident:
        raise ValueError("auto_rebuild requires slot_resident=True")
    if packed_scatter:
        if not auto_rebuild:
            raise ValueError(
                "packed_scatter is the auto-rebuild transport experiment "
                "(requires auto_rebuild=True)"
            )
        if scene.params.precision == "bf16":
            raise ValueError(
                "packed_scatter composes with fp32 features only "
                "(precision='bf16' already transports bf16 rows)"
            )
    if packed_rows:
        _check_packed(scene, method, xsub=xsub, row_pair=row_pair,
                      repair_k=repair_k, packed_scatter=packed_scatter)
    _check_slice(method)
    if sort_every <= 1:
        if grid is None and method == "pallas" and xsub > 1:
            grid = neighbors.GridSpec.for_scene(scene, xsub=xsub)
        step = make_step(scene, method, grid=grid,
                         row_pair=row_pair and method == "pallas",
                         packed_rows=packed_rows, row_lanes=row_lanes,
                         device=device)

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
        grid = neighbors.GridSpec.for_scene(scene, cap=base.cap, skin=skin,
                                            xsub=xsub)
    if packed_rows:
        sg = pallas_step.packed_grid(grid, row_lanes)
    else:
        sg = pallas_step.slot_grid(grid, row_pair=row_pair)
    blocks, rem = divmod(steps_per_dispatch, sort_every)
    if rem:
        raise ValueError(
            f"steps_per_dispatch={steps_per_dispatch} must be a "
            f"multiple of sort_every={sort_every}"
        )
    if slot_resident:
        if auto_rebuild:
            return _make_resident_auto_advance(
                scene, grid, sg, sort_every, blocks, skin,
                rebuild_frac=rebuild_frac, reactive_theta=reactive_theta,
                membership_audit=membership_audit, repair_k=repair_k,
                packed_scatter=packed_scatter, device=device,
            )
        return _make_resident_advance(
            scene, grid, sg, sort_every, blocks, skin, heal=heal,
            membership_audit=membership_audit, device=device,
        )
    step_a = make_step(scene, "pallas", grid=grid, with_addr=True,
                       row_pair=row_pair, packed_rows=packed_rows,
                       row_lanes=row_lanes, device=device)
    half2 = (0.5 * skin) ** 2
    use_mem = membership_audit and grid.xsub == 1

    def advance_reuse(state: State):
        viol = torch.zeros((), dtype=torch.int32, device=state.x.device)
        for _ in range(blocks):
            x0, act0 = state.x, state.active
            addr = pallas_step.build_addr(x0, act0, grid, sg)
            # fold build-time cap overflow in with the skin violations: both
            # mean silently-degraded physics
            viol = viol + addr.overflow
            if use_mem:
                _, flat0 = neighbors.cell_index(x0, act0, grid)
            for _ in range(sort_every):
                state = step_a(state, addr)
                d = state.x - x0
                bad = (torch.sum(d * d, dim=1) > half2) & act0
                if use_mem:
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


#: Production default of the minority-repair budget (repair_k=None), the
#: reference's (sph_tpu/step.py:1428-1435).
DEFAULT_REPAIR_K = 2048

#: Smallest estimated problem size at which repair_k=None resolves to
#: DEFAULT_REPAIR_K; below it, 0 (the reference's gate, step.py:1480-1486).
REPAIR_MIN_N = 32768

#: Constant-heal demotion: after DEMOTE_PATIENCE consecutive dispatches in
#: which every block healed, the resident policy demotes to the per-step
#: path (bitwise what heal-every-block computes, minus the failed fast
#: attempts) and re-probes the fast path every PERSTEP_REPROBE_EVERY
#: demoted dispatches (the reference's, step.py:1488-1500).
DEMOTE_PATIENCE = 2
PERSTEP_REPROBE_EVERY = 50


def _seed_estimate(scene: Scene) -> int:
    """Host-side problem-size estimate: explicit capacity, else the
    lattice count the scene's blocks would seed (same pitch as init)."""
    if scene.capacity:
        return int(scene.capacity)
    s = scene.spacing or scene.params.h * 0.55
    total = 0
    for b in scene.blocks:
        cells = 1
        for lo, hi in zip(b.lo, b.hi):
            cells *= max(1, int((hi - lo) / s))
        total += cells
    return total


def default_repair_k(
    scene: Scene, *, auto: bool, membership_audit: bool = True,
    xsub: int = 1, reactive_theta: float | None = None,
    row_pair: bool = False, packed_rows: bool = False,
) -> int:
    """Resolve repair_k=None to DEFAULT_REPAIR_K wherever minority slot
    repair is supported (auto-rebuild resident path, membership audit,
    xsub == 1, single-row slot layout, fp32, no reactive policy) and the
    scene is large enough for it to pay (REPAIR_MIN_N), else 0."""
    ok = (
        auto and membership_audit and xsub == 1 and not row_pair
        and not packed_rows
        and reactive_theta is None
        and scene.params.precision != "bf16"
        and _seed_estimate(scene) >= REPAIR_MIN_N
    )
    return DEFAULT_REPAIR_K if ok else 0


def make_audited_advance(
    scene: Scene, method: str, steps_per_dispatch: int,
    sort_every: int = 1, slot_resident: bool = False, xsub: int = 1,
    grid=None, adaptive_cap: bool = False, row_pair: bool = False,
    auto_rebuild: bool = True, reactive_theta: float | None = None,
    membership_audit: bool = True, repair_k: int | None = None,
    packed_rows: bool | None = None, row_lanes: int | None = None,
    device=None,
) -> Callable[[State], State]:
    """`advance(state) -> state` with the fast path's safety policy built
    in: when the skin/cap audit fires, the affected work is re-run from its
    held input state on the per-step path — fast when the skin bound
    holds, exact when not, never silently degraded.  For sort_every <= 1
    this is just `make_advance`.

    Non-resident reuse: the whole dispatch is re-run when its violation
    count (fetched once per dispatch) is not zero.

    slot_resident: the policy runs in-dispatch at block granularity (heal;
    with `auto_rebuild`, the default, the auto-rebuild resident advance and
    `repair_k=None` resolving through `default_repair_k`).  CONSTANT-HEAL
    DEMOTION: once every block of DEMOTE_PATIENCE consecutive dispatches
    heals, the advance demotes to the per-step path and re-probes the fast
    path every PERSTEP_REPROBE_EVERY dispatches.

    packed_rows=None with auto-rebuild on an emitter scene is the PACKED
    AUTO POLICY: the first dispatch probes `packed_fits` on the current
    state and runs packed rows or the slot layout; it switches packed →
    slot for good once more than blocks/8 blocks of a dispatch heal.

    The returned function carries `.healed`, `.repaired`, `.rebuilds`
    (cumulative blocks) and `.mode` ("resident", "perstep", "probe",
    "packed", "slot"), as the reference's does (`.rebuilds` is the port's
    own).  Its counters are host integers — the port takes the per-block
    decisions on the host — so reading them fetches nothing."""
    _check_slice(method, adaptive_cap=adaptive_cap)
    auto = auto_rebuild and slot_resident and sort_every > 1
    packed_auto = (
        packed_rows is None and auto and bool(scene.emitters)
        and method == "pallas" and grid is None and xsub == 1
        and not row_pair and scene.params.precision != "bf16"
        and reactive_theta is None
    )
    if packed_rows is None:
        packed_rows = False
    if repair_k is None:
        repair_k = default_repair_k(
            scene, auto=auto, membership_audit=membership_audit,
            xsub=xsub, reactive_theta=reactive_theta, row_pair=row_pair,
            packed_rows=packed_rows,
        )
    base_kw = dict(sort_every=sort_every, slot_resident=slot_resident,
                   xsub=xsub, heal=slot_resident and not auto,
                   row_pair=row_pair, auto_rebuild=auto,
                   reactive_theta=reactive_theta if auto else None,
                   membership_audit=membership_audit,
                   repair_k=repair_k if auto else 0,
                   packed_rows=packed_rows, row_lanes=row_lanes,
                   device=device)

    def _unpack(out):
        # (state, viol) | (state, viol, healed) | (+ rebuilds[, repairs])
        if len(out) > 3:
            audited.rebuilds += out[3]
        if len(out) > 4:
            audited.repaired += out[4]
        return out[0], (out[2] if len(out) > 2 else 0)

    def _note(msg: str) -> None:
        print(f"sph_tpu_torch: {msg}", file=sys.stderr)

    def _at(st: State) -> int:
        return _fetch(st.step)[0]

    if packed_auto:
        # probe the CURRENT state on the first dispatch, run packed while
        # the occupancy fits, switch to the slot layout for good once
        # row-overflow healing exceeds break-even
        blocks = max(steps_per_dispatch // sort_every, 1)
        advp: list = []
        advs: list = []

        def audited(st: State) -> State:
            if audited.mode == "probe":
                FETCHES["fetches"] += 1    # packed_fits reads the state
                audited.mode = ("packed"
                                if packed_fits(scene, st, sort_every, row_lanes)
                                else "slot")
                if audited.mode == "slot":
                    _note(f"occupancy too dense for packed rows at step "
                          f"{_at(st)} — running the slot fast path")
            if audited.mode == "packed":
                if not advp:
                    advp.append(make_advance(
                        scene, method, steps_per_dispatch,
                        **{**base_kw, "packed_rows": True, "repair_k": 0},
                    ))
                st2, healed = _unpack(advp[0](st))
                audited.healed += healed
                if healed > max(1, blocks // 8):
                    audited.mode = "slot"
                    _note(f"packed rows outgrown at step {_at(st)} "
                          f"({healed}/{blocks} blocks healed) — switching "
                          f"to the slot fast path")
                elif healed:
                    _note(f"skin/row violations at step {_at(st)} — "
                          f"{healed} block(s) re-ran exactly (in-dispatch)")
                return st2
            if not advs:
                advs.append(make_advance(
                    scene, method, steps_per_dispatch, **base_kw))
            st2, healed = _unpack(advs[0](st))
            audited.healed += healed
            if healed:
                _note(f"skin/cap violations at step {_at(st)} — {healed} "
                      f"block(s) re-ran exactly (in-dispatch)")
            return st2

        audited.healed = audited.repaired = audited.rebuilds = 0
        audited.mode = "probe"
        return audited

    adv = make_advance(scene, method, steps_per_dispatch, grid=grid,
                       **base_kw)
    if sort_every <= 1:
        return adv

    if slot_resident:
        blocks = max(steps_per_dispatch // sort_every, 1)
        streak = [0]       # consecutive all-blocks-healed fast dispatches
        demoted = [0]      # dispatches run since demotion (0 = fast path)
        perstep: list = []  # per-step advance, made at the first demotion

        def audited(st: State) -> State:
            if demoted[0]:
                # per-step is bitwise what heal-every-block computes, minus
                # the failed fast attempts; bounded re-probe
                demoted[0] += 1
                if demoted[0] % PERSTEP_REPROBE_EVERY:
                    return perstep[0](st)
                st2, healed = _unpack(adv(st))
                audited.healed += healed
                if healed >= blocks:
                    return st2  # still violent — stay demoted
                demoted[0] = 0
                streak[0] = 0
                audited.mode = "resident"
                _note(f"drift back under the Verlet budget at step {_at(st)} "
                      f"({healed}/{blocks} blocks healed) — resuming the "
                      f"resident fast path")
                return st2
            st2, healed = _unpack(adv(st))
            audited.healed += healed
            if healed:
                _note(f"skin/cap violations at step {_at(st)} — {healed} "
                      f"block(s) re-ran exactly (per-step rebuild, "
                      f"in-dispatch)")
            streak[0] = streak[0] + 1 if healed >= blocks else 0
            if streak[0] >= DEMOTE_PATIENCE:
                demoted[0] = 1
                if not perstep:
                    perstep.append(make_advance(
                        scene, method, steps_per_dispatch, device=device))
                audited.mode = "perstep"
                _note(f"flow outruns the Verlet drift budget — every block "
                      f"healed {streak[0]} dispatches straight at step "
                      f"{_at(st)}; demoting to the per-step path (re-probes "
                      f"every {PERSTEP_REPROBE_EVERY} dispatches)")
            return st2

        audited.healed = audited.repaired = audited.rebuilds = 0
        audited.mode = "resident"
        return audited

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
    xsub: int = 1,
    row_pair: bool = False,
    device=None,
) -> State:
    """Top-level loop: seed (unless `state` is given), prime leapfrog at
    step 0, then advance `n_steps` in dispatches of `steps_per_dispatch`,
    calling `frame_callback` after each.

    sort_every > 1 (pallas): Verlet-skin addr reuse with exact fallback —
    see make_audited_advance; `steps_per_dispatch` is rounded down to a
    multiple of `sort_every`, and a remainder that is no multiple runs per
    step.  slot_resident: the resident fast path (the production default is
    `sort_every=4, slot_resident=True`).  repair_k=None resolves to the
    production default (`default_repair_k`); packed_rows=None is the packed
    auto policy on emitter scenes of the resident path, the slot layout
    elsewhere; True/False pin it.  xsub and row_pair are the kernel
    layout options of `make_audited_advance` (the reference reaches them
    through `make_advance`; `run` passes them on, and the prime and the
    exact re-runs keep the default layout, as there)."""
    _check_slice(method, adaptive_cap=adaptive_cap, shards=shards)
    dev = resolve_device(device)
    if state is None:
        state = init(scene, device=dev)
    if scene.params.integrator == "leapfrog" and int(state.step) == 0:
        state = prime(scene, state, method=method, device=dev)
    if sort_every > 1:
        steps_per_dispatch -= steps_per_dispatch % sort_every
        steps_per_dispatch = max(steps_per_dispatch, sort_every)
    n_disp, rem = divmod(n_steps, steps_per_dispatch)
    kw = dict(membership_audit=membership_audit, repair_k=repair_k,
              packed_rows=packed_rows, xsub=xsub, row_pair=row_pair,
              device=dev)
    advance = make_audited_advance(scene, method, steps_per_dispatch,
                                   sort_every=sort_every,
                                   slot_resident=slot_resident,
                                   adaptive_cap=adaptive_cap, **kw)
    for _ in range(n_disp):
        state = advance(state)
        if frame_callback is not None:
            frame_callback(state)
    if rem:
        rem_reuse = sort_every if rem % sort_every == 0 else 1
        state = make_audited_advance(
            scene, method, rem, sort_every=rem_reuse,
            slot_resident=slot_resident and rem_reuse > 1, **kw)(state)
        if frame_callback is not None:
            frame_callback(state)
    return state
