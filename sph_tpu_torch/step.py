"""One simulation step, the advances and the run loop (port of
`sph_tpu/step.py`).

`make_step` builds `step(state) -> state`: density → EOS → forces →
integrate → boundaries.  PyTorch runs eagerly, so `make_advance` is a
Python loop over steps where the reference scans on the device; on the
card a step enqueues its work without a host sync.

Ported: `method="naive"`, `method="grid"` (cell tiles in plain PyTorch),
and `method="pallas"` on the slot layout or on packed rows, per step, with
Verlet-skin address reuse (`sort_every > 1`, audited, with an exact
re-run), and slot-resident (`slot_resident=True`): the classic resident
block with or without heal, and the auto-rebuild resident advance with its
membership-relaxed rebuild predicate, heal, minority slot repair and the
packed_scatter transport, under `make_audited_advance`'s policies
(constant-heal demotion, the packed-row auto policy, the cap-8 adaptive
policy); each with the kernel options `precision="bf16"`, `xsub` and
`row_pair`.  The reference branches inside its scan with `lax.cond`; here
each such decision is one fetch to the host at a block boundary (`FETCHES`
counts them).  `run(shards=N)` runs slabs across an N-rank
`torch.distributed` world (`decomp.py`), per step or on the slab fast
path, and `run(shards=(n1, n2))` pencils across n1·n2 ranks, per step.
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np
import torch

from sph_tpu_torch import neighbors, pallas_step, physics, slot_pass
from sph_tpu_torch.params import Scene
from sph_tpu_torch.platform import device_const, resolve_device, span
from sph_tpu_torch.repair import make_repair_tools
from sph_tpu_torch.state import State, init

def _check_slice(method: str) -> None:
    """Raise for an unknown method."""
    if method not in ("naive", "grid", "pallas"):
        raise ValueError(f"unknown neighbor method {method!r}")


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
    with span("sph.fetch"):
        if len(ts) == 1:
            return [ts[0].item()]
        return torch.stack([t.reshape(()).to(torch.int64)
                            for t in ts]).tolist()


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
    elif method == "grid":
        rho, p, f = neighbors.grid_rho_p_f(x, v, active, params, grid)
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
    if grid is None and method in ("grid", "pallas"):
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

    method: "naive" (O(N²)) | "grid" (cell tiles, plain PyTorch) |
    "pallas" (slot layout with kernels K1/K2, or packed rows with K3/K4
    when `packed_rows`).
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


class _SlotPhysics(slot_pass.SlotBody):
    """`slot_pass.SlotBody` (the slot-space physics of the block body) with
    the bf16 frame of the slots and the per-particle gather."""

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
                use_mem: bool, leap: bool, exchange=None, rp_hook=None,
                ci_offset=None, faces=None, budget=None, store=None):
    """`sort_every` steps integrated in slot space from the carry `c`
    (xs, vs, acc, x0s, movb, addr, ...), with the per-step drift audit:
    each step `slot_pass.slot_pre` (kick, drift, features), K1, K2 and
    `slot_pass.slot_post` (body forces, integration, audit) on a
    `slot_pass.SlotBlock` that is not the carry's, so the carry's arrays
    stay as they are: a fresh one, or the one `store` (a
    `slot_pass.SlotStore`) gives, whose first pass then visits only the
    occupied groups when the storage is filled for the carry's
    addressing.  Where the store's full first pass copies the build's
    positions out of the carry's scatter array, `c["x0s"]` becomes that
    copy (the same values).  Returns (xs, vs, acc, rp, violations, risky):
    xs and vs are views of the block's feature array, the counts device
    scalars; `risky` (None without a `budget`) counts the slots of the
    membership rebuild predicate on the block's end
    (`slot_pass.membership_risky`, the faces its extra margin), which the
    last slot_post computes.  The leapfrog block-top kick uses `c["acc"]`
    (None on a fresh carry, whose kick was pre-applied in particle space).

    The hooks of a slab (`decomp._SlabSlots`, whose carries hold an acc):
    `exchange(xs, vs)` writes the ghost slots in place after each step's
    drift, into the array K1 reads, except at step 0 of a carry marked
    `drifted` (its kick, drift and exchange came before its build);
    `rp_hook(rp)` writes the ghosts' (rho, p) into K1's rp before K2; the
    membership audit places the slab-local lattice by `ci_offset` and keeps
    the strict budget past the faces of `faces` (a `decomp._Slab`)."""
    params, d = sp.params, sp.d
    dt = params.dt
    addr, sg, movb = c["addr"], sp.sg, c["movb"]
    bf16 = params.precision == "bf16"
    if bf16 and exchange is not None:
        raise ValueError("the slab hooks take fp32 features")
    with span("sph.block"):
        centers = sp.slot_centers(addr) if bf16 else None
        if store is None:
            blk, full, x0 = (slot_pass.SlotBlock(
                sg.c_rows, sg.lanes, d, bf16, movb.device), True, None)
        else:
            blk, full, x0 = store.take(c)
        tiles = None           # the kernels' walk of the occupied groups
        if movb.is_cuda:
            tiles = (slot_pass.occupied_tiles(addr.gcounts, addr.n_occ)
                     if store is None else store.tiles(addr))
        plan = slot_pass.PostPlan(sp, leap, half2, use_mem, ci_offset,
                                  faces, budget, sort_every)
        xs, vs, acc = c["xs"], c["vs"], c["acc"]
        jb = c["jb"]
        for i in range(sort_every):
            moved = bool(i) or not c.get("drifted")
            kick = leap and moved and acc is not None
            drift = leap and moved
            if i == 0 or kick or drift or bf16:
                slot_pass.slot_pre(blk, xs, vs, acc, movb, addr.gcounts,
                                   addr.n_occ, dt, kick, drift, i == 0,
                                   centers, full=full and i == 0,
                                   x0=x0 if i == 0 else None, tiles=tiles)
            if i == 0 and x0 is not None:
                c["x0s"] = x0
            xs, vs, acc = blk.xs, blk.vs, blk.acc
            if exchange is not None and moved:
                exchange(xs, vs)
            feat = blk.kernel_feat
            rp = pallas_step._call_density(feat, addr, sg, params, jb)
            if rp_hook is not None:
                rp_hook(rp)
            f_s = pallas_step._call_force(feat, rp, addr, sg, params, jb)
            slot_pass.slot_post(blk, rp, f_s, c["x0s"], movb, addr, plan,
                                c["step0"], i, i == sort_every - 1,
                                tiles=tiles)
        if store is not None:
            store.done(c, blk)
    return xs, vs, acc, rp, blk.count, None if budget is None else blk.risky


def _scatter_residency(x, v, act, movable, grid, sg, use_mem: bool,
                       ci_offset=None) -> dict:
    """Addressing and scatter of (x, v) into slot residency, 7 scatter
    columns x | v | movable; `ci_offset` places a slab-local lattice."""
    d = x.shape[1]
    addr = pallas_step.build_addr(x, act, grid, sg, ci_offset)
    zpad = x.new_zeros((x.shape[0], 3 - d))
    rows = torch.cat([x, zpad, v, zpad, movable[:, None].to(torch.float32)],
                     dim=1)
    feat = pallas_step.scatter_slots(addr, rows, sg)
    xs = feat[:, 0:d, :]
    return dict(
        addr=addr, feat=feat, xs=xs, vs=feat[:, 3:3 + d, :], x0s=xs,
        movb=feat[:, 6:7, :] > 0,
        refs=slot_pass.slot_bin_refs(addr, sg) if use_mem else None,
        jb=pallas_step._jblocks(addr, sg) if sg.packed else None,
    )


def _residency(s: State, grid, sg, d: int, dt: float, leap: bool,
               use_mem: bool) -> dict:
    """Particle state → slot residency (build + scatter), the classic
    block-top sequence.  The leapfrog half-kick is pre-applied in particle
    space (bitwise the same elementwise arithmetic), so acc is not
    scattered; the 7 scatter columns are x | v_half | movable."""
    act0 = s.active
    movable0 = act0 & (s.kind == 0)
    movf = movable0[:, None].to(torch.float32)
    v_in = s.v + (0.5 * dt) * s.acc * movf if leap else s.v
    return dict(_scatter_residency(s.x, v_in, act0, movable0, grid, sg,
                                   use_mem), step0=s.step)


def _read_back(sp: _SlotPhysics, c, x, v, acc, rho, p, act0, movable0):
    """Slots → the (x, v, acc, rho, p) of the first len(x) particles of
    the carry's addressing (a slab's ghosts after them are not read);
    particles without a slot keep the values passed in."""
    n, addr, d = x.shape[0], c["addr"], sp.d
    with span("sph.gather"):
        ok = addr.ok()[:n]
        okc = ok[:, None]
        row = torch.where(ok, addr.row_pos[:n], 0).long()
        pos = torch.where(ok, addr.pos[:n], 0).long()

        def gather(slot, ncomp):
            return slot[row, :ncomp, pos]

        rho_p = torch.where(ok & act0, gather(c["rp"], 1)[:, 0], rho)
        return (torch.where(okc, gather(c["xs"], d), x),
                torch.where(okc, gather(c["vs"], d), v),
                torch.where(okc & movable0[:, None], gather(c["acc"], d),
                            acc),
                rho_p,
                torch.where(ok & act0,
                            physics.eos_pressure(rho_p, sp.params), p))


def _materialize(sp: _SlotPhysics, c, s: State, step) -> State:
    """Slots → particle State (non-slotted particles keep the values of
    `s`, the state the residency was entered from)."""
    act0 = s.active
    x, v, acc, rho, p = _read_back(sp, c, s.x, s.v, s.acc, s.rho, s.p, act0,
                                   act0 & (s.kind == 0))
    return s.replace(x=x, v=v, acc=acc, rho=rho, p=p, step=step)


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
            c["acc"] = None
            xs, vs, a_s, rp, viol_blk, _ = _slot_steps(
                sp, c, sort_every, half2, use_mem, leap)
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
        `rebuild_frac · skin/2` (`slot_pass.membership_risky`);
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

    The blocks of a dispatch share one `slot_pass.SlotStore`: a block
    writes the storage its top does not hold, and a block whose storage is
    filled for its addressing runs its first slot_pre over the occupied
    groups only; a repair patches the filled storage in place.

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
            refs=slot_pass.slot_bin_refs(addr, sg) if use_mem else None,
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

    # the membership predicate is counted by the block's last slot_post
    fused_need = reactive_theta is None and use_mem and rebuild_frac > 0

    def need_of(c, risky=None):
        """(need, activated) device bools of the block that starts from
        `c`; `risky`: the predicate's slots on `c`, counted by the block
        that ended in it."""
        s = c["shadow"]
        activated = torch.any((s.emit_step > c["build_step"])
                              & (s.emit_step <= s.step))
        if risky is not None:
            return (risky > 0) | activated, activated
        dd = c["xs"] - c["x0s"]
        dd2 = torch.sum(dd * dd, dim=1, keepdim=True)
        if reactive_theta is not None:
            drift_now = torch.sqrt(torch.amax(dd2))
            need = (drift_now > reactive_theta * 0.5 * skin) | activated
        elif fused_need:
            risky = slot_pass.membership_risky(c, grid, dd2, dt, sort_every,
                                               budget)
            need = torch.any(risky) | activated
        else:
            drift_now = torch.sqrt(torch.amax(dd2))
            vmax = torch.sqrt(torch.amax(torch.sum(c["vs"] * c["vs"], dim=1)))
            predicted = drift_now + 1.2 * vmax * dt * sort_every
            need = (predicted > budget) | activated
        return need, activated

    def rebuild(c):
        with span("sph.rebuild"):
            return enter_slots(materialize(c))

    if repair_k:
        plan_t, apply_t = make_repair_tools(
            grid, sg, d, dt, sort_every, budget, repair_k, sp.gather)

        def plan_repair(c):
            s = c["shadow"]
            act0 = s.active
            return plan_t(c, s.x, act0, act0 & (s.kind == 0))

        def apply_repair(c, plan, store):
            # advance the repaired particles' plan anchors (shadow.x is x0
            # in plan_repair), else they stay phantom-risky against their
            # OLD cell; materialize and heal read shadow.x only for
            # non-slotted or pre-live particles
            sh = c["shadow"]
            c2 = apply_t(c, plan, store.filled(c), anchors=sh.x)
            store.readdress(c["addr"], c2["addr"])
            x = c2.pop("anchors")
            return {**c2, "shadow": sh.replace(x=x)}

    def advance(state: State):
        _on(state, dev)
        store = slot_pass.SlotStore(sg, d, params.precision == "bf16", dev)
        with span("sph.rebuild"):
            c = enter_slots(state)
        healed, rebuilds, repairs = 0, 1, 0
        need_t, act_t = need_of(c)
        (need,) = _fetch(need_t)
        for b in range(blocks):
            FETCHES["blocks"] += 1
            more = b + 1 < blocks
            if need:
                fixed = None
                if repair_k:
                    with span("sph.repair"):
                        plan = plan_repair(c)
                        if _fetch(plan["can"] & ~act_t)[0]:
                            fixed = apply_repair(c, plan, store)
                if fixed is None:
                    c = rebuild(c)
                    rebuilds += 1
                else:
                    c = fixed
                    repairs += 1
            c["step0"] = c["shadow"].step
            xs, vs, acc_s, rp, viol_blk, risky = _slot_steps(
                sp, c, sort_every, half2, use_mem, leap,
                budget=budget if fused_need else None, store=store)
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
                need_t, act_t = need_of(ok_carry, risky)
                bad, need = _fetch(viol_blk > 0, need_t)
            else:
                (bad,) = _fetch(viol_blk > 0)
            if bad:
                # exact per-step re-run of this block from its held slot
                # top, then fresh residency (bitwise the classic path)
                with span("sph.heal"):
                    sm = materialize(c)
                    for _ in range(sort_every):
                        sm = exact_step(sm)
                    c = enter_slots(sm)
                    if more:
                        need_t, act_t = need_of(c)
                        (need,) = _fetch(need_t)
                healed += 1
                rebuilds += 1
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
    slot_resident: bool = False, xsub: int = 1, xb_cells: int = 4,
    heal: bool = False, row_pair: bool = False, auto_rebuild: bool = False,
    rebuild_frac: float = 1.0, reactive_theta: float | None = None,
    membership_audit: bool = True, repair_k: int = 0,
    packed_scatter: bool = False, packed_rows: bool = False,
    row_lanes: int | None = None, device=None,
):
    """`advance(state) -> state` running `steps_per_dispatch` steps.

    xsub > 1 (pallas, no `grid` given): the slot layout subdivides each x
    cell into xsub slot-cells (`GridSpec.for_scene(xsub=)`); the audits then
    fall back to the strict drift test, as in the reference.  row_pair: see
    `make_step`.  xb_cells is the reference's Mosaic window width, taken
    for signature parity; the CUDA kernels have no such window.

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


def cap8_skin(scene: Scene, state: State, sort_every: int = 4):
    """The skin of the cap-8 policy's lattice for `state`: the widest of
    default_skin / {1, 2, 4} whose cap-8 cells all hold at most 8 of its
    active particles, or None when none does.  One fetch a candidate."""
    full = default_skin(scene, sort_every)
    for k in (1, 2, 4):
        g = neighbors.GridSpec.for_scene(scene, cap=8, skin=full / k)
        _, flat = neighbors.cell_index(state.x, state.active, g)
        counts = torch.bincount(flat.long(), minlength=g.n_rows)
        if _fetch(torch.sum(counts[: g.n_cells] > 8))[0] == 0:
            return full / k
    return None


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

    adaptive_cap (slot_resident, no `grid`, a default cap above 8) is the
    CAP-8 POLICY: the first dispatch probes the current state for the
    widest of the skins default_skin / {1, 2, 4} whose cap-8 lattice holds
    every cell (none: the default cap from the start), runs the resident
    advance on that cap-8 slot grid, heals its rare overflow blocks
    exactly, and switches to the default cap for good once more than
    blocks/8 blocks of a dispatch heal.  The packed auto policy stays off
    under it, as in the reference.

    The returned function carries `.healed`, `.repaired`, `.rebuilds`
    (cumulative blocks) and `.mode` ("resident", "perstep", "probe",
    "packed", "slot", "cap8", "cap16"), as the reference's does
    (`.rebuilds` is the port's own, as are the cap-8 policy's `.skin`, the
    skin of its cap-8 lattice once probed, `.cap8_blocks`, the blocks run
    on that lattice, and `.switch_step`, the step at which the mode left
    "cap8", or None).  Its counters are host integers — the port takes
    the per-block decisions on the host — so reading them fetches nothing.
    The cap-8 policy marks its probe (`sph.cap_probe`) and each dispatch
    on the cap-8 lattice (`sph.cap8`) for the profiler."""
    _check_slice(method)
    auto = auto_rebuild and slot_resident and sort_every > 1
    packed_auto = (
        packed_rows is None and auto and bool(scene.emitters)
        and method == "pallas" and grid is None and not adaptive_cap
        and xsub == 1 and not row_pair
        and scene.params.precision != "bf16"
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

    base_grid = neighbors.GridSpec.for_scene(scene) if adaptive_cap else None
    if adaptive_cap and slot_resident and grid is None and base_grid.cap > 8:
        # kernel cost is quantized by the slot cap, so the skin shrinks
        # until the CURRENT occupancy fits 8 (the price is rebuild rate,
        # which the auto-rebuild advance adapts to)
        skin_full = default_skin(scene, sort_every)
        blocks = max(steps_per_dispatch // sort_every, 1)
        wide = f"cap{base_grid.cap}"
        adv8: list = []
        adv16: list = []

        def _probe(st: State) -> None:
            pick = cap8_skin(scene, st, sort_every)
            if pick is None:
                audited.mode = wide
                audited.switch_step = _at(st)
                _note(f"occupancy exceeds 8 on every cap-8 candidate "
                      f"lattice at step {audited.switch_step} — running "
                      f"the cap-{base_grid.cap} fast path")
                return
            if pick != skin_full:
                _note(f"cap-8 lattice skin narrowed {skin_full:.3g} → "
                      f"{pick:.3g} (occupancy-fit; rebuild rate adapts)")
            audited.skin = pick
            adv8.append(make_advance(
                scene, method, steps_per_dispatch, xb_cells=8,
                grid=neighbors.GridSpec.for_scene(scene, cap=8, skin=pick),
                **base_kw))

        def audited(st: State) -> State:
            if audited.mode == "cap8" and not adv8:
                with span("sph.cap_probe"):
                    _probe(st)
            if audited.mode == "cap8":
                b0 = FETCHES["blocks"]
                with span("sph.cap8"):
                    st2, healed = _unpack(adv8[0](st))
                audited.cap8_blocks += FETCHES["blocks"] - b0
                audited.healed += healed
                if healed > max(1, blocks // 8):
                    at = _at(st)
                    audited.mode = wide
                    audited.switch_step = at + steps_per_dispatch
                    _note(f"cap-8 occupancy outgrown at step {at} "
                          f"({healed}/{blocks} blocks healed) — switching "
                          f"to the cap-{base_grid.cap} fast path")
                elif healed:
                    _note(f"skin/cap violations at step {_at(st)} — "
                          f"{healed} block(s) re-ran exactly (in-dispatch)")
                return st2
            if not adv16:
                adv16.append(make_advance(
                    scene, method, steps_per_dispatch, **base_kw))
            st2, healed = _unpack(adv16[0](st))
            audited.healed += healed
            if healed:
                _note(f"skin/cap violations at step {_at(st)} — {healed} "
                      f"block(s) re-ran exactly (in-dispatch)")
            return st2

        audited.healed = audited.repaired = audited.rebuilds = 0
        audited.cap8_blocks = 0
        audited.mode = "cap8"
        audited.skin = audited.switch_step = None
        return audited

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
    shard_axis: int = 0,
    shard_axis2: int | None = None,
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
    exact re-runs keep the default layout, as there).

    shards=N: slabs along `shard_axis` across the N ranks of the
    initialized `torch.distributed` process group (as under `torchrun
    --nproc-per-node N`), each on `device` (default `cuda:LOCAL_RANK`):
    the state is sharded once, advanced with
    `decomp.make_audited_spatial_advance` (per-step slabs, or with
    `sort_every > 1` the slab fast path: its spec sized for the Verlet
    skin, `slot_resident` the auto-rebuild resident blocks with heal,
    repair and demotion, `membership_audit` and `repair_k` as on one
    device), re-specced from the gathered state when the flow outgrows the
    static buffers, and the GLOBAL state is returned on every rank (and
    passed to `frame_callback` after each dispatch).  Its capacity is n ×
    the local capacity and its particle order follows slab ownership.
    `steps_per_dispatch` and the remainder follow the single-device rules
    above.  `packed_rows` is ignored there, with a notice, as in the
    reference; `adaptive_cap` is not read.

    shards=(n1, n2): pencils over (`shard_axis`, `shard_axis2`, default
    the last axis) across n1·n2 ranks, rank i1·n2 + i2 holding pencil
    (i1, i2), with `decomp.make_audited_pencil_advance`: per step only, as
    in the reference, so `sort_every` and `slot_resident` are downgraded
    to 1 and False.  The rest as for slabs."""
    _check_slice(method)
    dims = (shards,) if isinstance(shards, int) else tuple(shards or ())
    dims = dims if any(dims) else ()    # 0 or None: one device
    if len(dims) == 2:
        shard_axis2 = (scene.params.dim - 1 if shard_axis2 is None
                       else shard_axis2)
        if shard_axis2 == shard_axis:
            raise ValueError("shard_axis2 must differ from shard_axis")
    if dims:
        from sph_tpu_torch import comm

        world = int(np.prod(dims))
        if not _dist_ready(world):
            raise ValueError(
                f"run(shards={shards}) needs an initialized torch.distributed "
                f"process group of {world} ranks, one process per rank: "
                f"start it under `torchrun --nproc-per-node {world}` and "
                f"call torch.distributed.init_process_group first")
        if xsub != 1 or row_pair:
            raise ValueError(
                "xsub and row_pair are single-device layout options; "
                "not with shards")
        dev = comm.rank_device(device)
    else:
        dev = resolve_device(device)
    if state is None:
        state = init(scene, device=dev)
    if scene.params.integrator == "leapfrog" and int(state.step) == 0:
        state = prime(scene, state, method=method, device=dev)
    if dims:
        if packed_rows is not None:
            # packed rows are single-device only; slabs use the slot layout
            print("sph_tpu_torch: packed_rows is single-chip only; ignored "
                  "with shards (slot layout used)", file=sys.stderr)
        return _run_decomposed(
            scene, n_steps, method, steps_per_dispatch, state,
            frame_callback, dims, (shard_axis, shard_axis2), dev,
            sort_every=sort_every, slot_resident=slot_resident,
            membership_audit=membership_audit, repair_k=repair_k)
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


def _dist_ready(world: int) -> bool:
    """A torch.distributed process group of `world` ranks is initialized."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == world)


def _run_decomposed(scene, n_steps, method, steps_per_dispatch, state,
                    frame_callback, dims: tuple, axes: tuple, dev,
                    sort_every: int = 1, slot_resident: bool = False,
                    membership_audit: bool = True, repair_k=None):
    """run(shards=): shard once, advance with the audited slab (dims (N,))
    or pencil (dims (n1, n2), over `axes`) path, re-spec elastically on
    static-cap outgrowth (`decomp.SpatialCapOverflow`, raised on every rank
    together), gather the global view for the callback and the return
    value.  Every rank computes each spec from the same gathered arrays.
    The fast path's spec sizes its ghost band for the Verlet skin; a
    remainder dispatch keeps the fast path only when `sort_every` divides
    it.  Pencils step per step."""
    from sph_tpu_torch import decomp

    pencil = len(dims) == 2
    if pencil:
        sort_every, slot_resident = 1, False
    if sort_every > 1:
        if method != "pallas":
            raise ValueError("sort_every > 1 requires method='pallas'")
        steps_per_dispatch -= steps_per_dispatch % sort_every
        steps_per_dispatch = max(steps_per_dispatch, sort_every)
    skin = default_skin(scene, sort_every) if sort_every > 1 else 0.0

    def build(st, spd, se, resident):
        if pencil:
            spec = decomp.PencilSpec.for_state(scene, st, *dims,
                                               axis1=axes[0], axis2=axes[1])
            loc = decomp.pencil_shard_state(st, scene, spec, dev)
            return loc, decomp.make_audited_pencil_advance(scene, spec,
                                                           method, spd)
        spec = decomp.SpatialSpec.for_state(scene, st, dims[0], axis=axes[0],
                                            skin=skin if se > 1 else 0.0)
        loc = decomp.spatial_shard_state(st, scene, spec, dev)
        return loc, decomp.make_audited_spatial_advance(
            scene, spec, method, spd, sort_every=se, slot_resident=resident,
            membership_audit=membership_audit, repair_k=repair_k)

    def advance_block(loc, adv, spd, se, resident):
        try:
            return adv(loc), adv
        except decomp.SpatialCapOverflow:
            # the flow outgrew the static buffers: re-size from the
            # dispatch's input and run it again
            loc2, adv2 = build(decomp.spatial_gather_state(loc), spd, se,
                               resident)
            return adv2(loc2), adv2

    n_disp, rem = divmod(n_steps, steps_per_dispatch)
    loc, adv = build(state, steps_per_dispatch, sort_every, slot_resident)
    for _ in range(n_disp):
        loc, adv = advance_block(loc, adv, steps_per_dispatch, sort_every,
                                 slot_resident)
        if frame_callback is not None:
            frame_callback(decomp.spatial_gather_state(loc))
    if rem:
        se = sort_every if sort_every > 1 and rem % sort_every == 0 else 1
        resident = slot_resident and se > 1
        loc, adv = build(decomp.spatial_gather_state(loc), rem, se, resident)
        loc, adv = advance_block(loc, adv, rem, se, resident)
        if frame_callback is not None:
            frame_callback(decomp.spatial_gather_state(loc))
    return decomp.spatial_gather_state(loc)
