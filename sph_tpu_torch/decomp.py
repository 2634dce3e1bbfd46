"""Domain decomposition on `torch.distributed` (port of
`sph_tpu/decomp.py`: the particle-DP step and the per-step slabs).

One process per rank (SPMD): rank r holds only its own part of the state,
as `State` tensors of `[cap_local, ...]`, exactly the reference's row r of
its `[n, cap_local, ...]` stack under `shard_map`.  The collectives are
the four of `comm.py`; every rank issues the same ones in the same order.

1. `make_dp_step`, data-parallel over particles: each rank owns a fixed
   slice of the capacity, all-gathers x, v and the active mask once per
   force evaluation and sums pairs for its own rows.  Per row the sums are
   those of the naive path, so the trajectory is bitwise the naive step's:
   the anchor of the collectives.  It holds `[cap/n, cap, D]` pair arrays,
   so it is for small scenes.

2. `make_spatial_step` / `make_spatial_advance`, slabs along one axis: per
   step each rank
     (a) sends the particles within h of its faces to its ring neighbors
         as ghosts (fixed-capacity buffers with a valid column),
     (b) computes density over locals + ghosts on a slab-local lattice
         (`GridSpec.for_slab`, shifted by an integer `ci_offset`), then
         re-imports the ghosts' (rho, p) from their owners and computes
         forces,
     (c) integrates its locals, and
     (d) migrates particles that crossed a face into the receiver's
         INACTIVE slots (pending emitter slots are never overwritten).
   Slot order changes under migration, so a decomposed run is held to
   exact conservation and tight-tolerance trajectories, not bitwise.
   Under method="pallas" step (b) is K1 and K2 through the split API
   (`pallas_step.pallas_split_build` / `pallas_density_split` /
   `pallas_forces_split`).

Compactions are padded and stay on the device (no `nonzero`): a selected
row past a buffer's capacity is counted as overflow, and the per-step
overflow counts are summed over ranks once per dispatch.

The slab fast path (`sort_every > 1`, slot-resident, auto-rebuild) and
pencils come with ROADMAP.md Queue 1 items 14.3 and 14.4.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sph_tpu_torch import comm, neighbors, pallas_step, physics
from sph_tpu_torch.params import Scene
from sph_tpu_torch.state import _FIELDS, INACTIVE, State
from sph_tpu_torch.step import _not_ported

_ARRAYS = tuple(f for f in _FIELDS if f != "step")


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _host(a) -> np.ndarray:
    """A host array of a tensor or of anything `np.asarray` takes."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _local_state(arrays: dict, step, device) -> State:
    step = int(_host(step))
    return State(
        step=torch.tensor(step, dtype=torch.int32, device=device),
        **{k: torch.as_tensor(np.ascontiguousarray(arrays[k]), device=device)
           for k in _ARRAYS},
    )


# ---------------------------------------------------------------------------
# 1. Data-parallel over particles (bitwise anchor)
# ---------------------------------------------------------------------------


def shard_state(state: State, device=None) -> State:
    """This rank's slice of a global `state` (the same on every rank), its
    capacity padded to a multiple of the world size (pad rows: rho 1,
    emit_step INACTIVE, zeros elsewhere)."""
    dev = comm.rank_device(device)
    n, r = comm.world_size(), comm.rank()
    arrays = {k: _host(getattr(state, k)) for k in _ARRAYS}
    cap = arrays["x"].shape[0]
    pad = _round_up(cap, n) - cap
    fill = {"rho": 1.0, "emit_step": INACTIVE}
    for k, a in arrays.items():
        if pad:
            rows = np.full((pad,) + a.shape[1:], fill.get(k, 0), a.dtype)
            a = np.concatenate([a, rows], axis=0)
        per = a.shape[0] // n
        arrays[k] = a[r * per:(r + 1) * per]
    return _local_state(arrays, state.step, dev)


def make_dp_step(scene: Scene):
    """Particle-sharded all-pairs step on this rank's slice; bitwise the
    naive `step.make_step` (both integrators, force fields)."""
    params = scene.params
    dt = params.dt
    if params.integrator not in ("leapfrog", "euler"):
        raise ValueError(f"unknown integrator {params.integrator!r}")

    def rho_p_f(x, v, active, step):
        x_all = comm.all_gather(x)
        v_all = comm.all_gather(v)
        act_all = comm.all_gather(active)
        dx = x[:, None, :] - x_all[None, :, :]
        r2 = torch.sum(dx * dx, dim=-1)
        mask = act_all[None, :].to(x.dtype)
        rho = torch.sum(physics.density_contrib(r2, mask, params), dim=1)
        rho = torch.where(active, rho,
                          torch.full_like(rho, params.rest_density))
        p = physics.eos_pressure(rho, params)
        rho_all = comm.all_gather(rho)
        p_all = comm.all_gather(p)
        f = torch.sum(
            physics.force_contrib(
                dx, r2, v[:, None, :], v_all[None, :, :], p[:, None],
                p_all[None, :], rho_all[None, :], mask, params,
            ),
            dim=1,
        ) * active[:, None].to(x.dtype)
        f = f + physics.gravity_force(rho, params)
        if params.boundary_mode == "penalty":
            f = f + physics.wall_penalty_force(x, v, scene.lo, scene.hi,
                                               params)
        if scene.force_fields:
            f = f + physics.force_field_force(x, step, scene.force_fields)
        return rho, p, f

    def step(st: State) -> State:
        active = st.active
        movable = active & (st.kind == 0)
        mov = movable[:, None].to(st.x.dtype)
        x, v, acc = st.x, st.v, st.acc
        if params.integrator == "leapfrog":
            v = v + (0.5 * dt) * acc * mov
            x = x + dt * v * mov
            rho, p, f = rho_p_f(x, v, active, st.step)
            a = f / torch.clamp(rho, min=1e-12)[:, None]
            v = v + (0.5 * dt) * a * mov
        else:
            rho, p, f = rho_p_f(x, v, active, st.step)
            a = f / torch.clamp(rho, min=1e-12)[:, None]
            v = v + dt * a * mov
            x = x + dt * v * mov
        acc = torch.where(movable[:, None], a, 0.0)
        if params.boundary_mode == "clamp":
            xc, vc = physics.clamp_boundary(x, v, scene.lo, scene.hi, params)
            x = torch.where(movable[:, None], xc, x)
            v = torch.where(movable[:, None], vc, v)
        return State(
            x=x, v=v, acc=acc,
            rho=torch.where(active, rho, st.rho),
            p=torch.where(active, p, st.p),
            kind=st.kind, emit_step=st.emit_step, step=st.step + 1,
        )

    return step


# ---------------------------------------------------------------------------
# 2. Spatial slab decomposition with halo exchange + migration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpatialSpec:
    """Static decomposition geometry: slabs along `axis` of the domain
    (the reference's fields, one for one)."""

    n_shards: int
    axis: int            # position component the domain is sliced along
    slab_lo: float       # global domain lo along axis
    slab_w: float        # slab width
    cap_local: int       # particle capacity per rank
    cap_ghost: int       # ghost-buffer capacity per face
    cap_mig: int         # migration-buffer capacity per face

    @staticmethod
    def for_scene(scene: Scene, n_shards: int, capacity: int, axis: int = 0,
                  balance: float = 4.0) -> "SpatialSpec":
        """`balance` is the tolerated load imbalance: each slab can hold up
        to balance× the even share."""
        lo, hi = scene.lo[axis], scene.hi[axis]
        slab_w = (hi - lo) / n_shards
        if slab_w < 2 * scene.params.h:
            raise ValueError(
                f"slab width {slab_w} < 2h; fewer shards or a wider domain")
        cap_local = min(
            _round_up(capacity, 64),
            _round_up(int(capacity / n_shards * balance) + 64, 64),
        )
        return SpatialSpec(
            n_shards=n_shards, axis=axis, slab_lo=lo, slab_w=slab_w,
            cap_local=cap_local,
            cap_ghost=_round_up(cap_local // 2 + 64, 64),
            cap_mig=_round_up(cap_local // 4 + 64, 64),
        )

    @staticmethod
    def for_state(scene: Scene, state, n_shards: int, axis: int = 0,
                  headroom: float = 3.0, skin: float = 0.0) -> "SpatialSpec":
        """Sized from the state's worst slab occupancy × headroom, and the
        ghost/migration buffers from the worst interior-face band (within
        2·(h + skin) of a face), with floors for small scenes.  The
        advance still audits every cap."""
        lo, hi = scene.lo[axis], scene.hi[axis]
        slab_w = (hi - lo) / n_shards
        if slab_w < 2 * scene.params.h:
            raise ValueError(
                f"slab width {slab_w} < 2h; fewer shards or a wider domain")
        x = _host(state.x)
        live = _host(state.emit_step) != int(INACTIVE)
        slab = np.clip(((x[:, axis] - lo) // slab_w).astype(int), 0,
                       n_shards - 1)
        worst = int(np.bincount(slab[live], minlength=n_shards).max())
        cap_local = min(
            _round_up(x.shape[0], 64),
            _round_up(int(worst * headroom) + 64, 64),
        )
        h_eff = scene.params.h + skin
        band = 0
        xa = x[live, axis]
        for i in range(1, n_shards):
            face = lo + i * slab_w
            band = max(band, int(np.sum(np.abs(xa - face) < 2.0 * h_eff)))
        cap_ghost = min(
            _round_up(cap_local // 2 + 64, 64),
            _round_up(int(band * headroom) + 256, 64),
        )
        return SpatialSpec(
            n_shards=n_shards, axis=axis, slab_lo=lo, slab_w=slab_w,
            cap_local=cap_local, cap_ghost=cap_ghost,
            cap_mig=max(_round_up(cap_ghost // 2, 64), 256),
        )


def _pack_idx(mask: torch.Tensor, cap: int):
    """Padded compaction indices: (idx [cap] i64, valid [cap], overflow).
    The k-th selected row goes to entry k; entries past the selection
    hold the fill index n; selected rows past `cap` are counted, not
    kept.  The reference's `nonzero(size=cap, fill_value=n)`."""
    n = mask.shape[0]
    k = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    idx = torch.full((cap + 1,), n, dtype=torch.int64, device=mask.device)
    idx.index_put_((torch.where(mask & (k < cap), k, cap),),
                   torch.arange(n, device=mask.device))
    idx = idx[:cap]
    overflow = torch.clamp(torch.sum(mask, dtype=torch.int32) - cap, min=0)
    return idx, idx < n, overflow


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t's rows at idx; the pad fill index n reads a zero row.  Only the
    selected rows are read: the payloads are packed after the gather, so
    no [N, F] payload is built."""
    n = t.shape[0]
    keep = (idx < n).view((-1,) + (1,) * (t.dim() - 1))
    return torch.where(keep, t[torch.clamp(idx, max=n - 1)],
                       torch.zeros((), dtype=t.dtype, device=t.device))


def _slab_of(x: np.ndarray, spec: SpatialSpec) -> np.ndarray:
    return np.clip(((x[:, spec.axis] - spec.slab_lo) // spec.slab_w)
                   .astype(int), 0, spec.n_shards - 1)


def spatial_slabs(state, spec: SpatialSpec) -> list[dict]:
    """Host-side split of a global state into the per-slab arrays
    ({field: [cap_local, ...]} for each slab): live slots (active, or
    scheduled to activate: pending emitter slots go to the slab of their
    spawn position) in their order, then pads parked at −1e6 with
    emit_step INACTIVE and rho 1."""
    x = _host(state.x)
    live = _host(state.emit_step) != int(INACTIVE)
    slab = _slab_of(x, spec)
    fields = {k: _host(getattr(state, k)) for k in _ARRAYS}
    park = x.min(axis=0) * 0 + np.float32(-1e6)
    out = []
    for s in range(spec.n_shards):
        sel = live & (slab == s)
        cnt = int(sel.sum())
        if cnt > spec.cap_local:
            raise ValueError(
                f"slab {s} holds {cnt} > cap_local {spec.cap_local}")
        pad = spec.cap_local - cnt
        arrays = {}
        for k, arr in fields.items():
            take = arr[sel]
            if k == "x":
                fill = np.broadcast_to(park, (pad, take.shape[1]))
            elif k == "emit_step":
                fill = np.full((pad,), INACTIVE, take.dtype)
            elif k == "rho":
                fill = np.ones((pad,), take.dtype)
            else:
                fill = np.zeros((pad,) + take.shape[1:], take.dtype)
            arrays[k] = np.concatenate([take, fill], axis=0)
        out.append(arrays)
    return out


def spatial_shard_state(state, scene: Scene, spec: SpatialSpec,
                        device=None) -> State:
    """This rank's slab of a global `state` (the same on every rank) as a
    local State on its device."""
    if comm.world_size() != spec.n_shards:
        raise ValueError(
            f"the spec has {spec.n_shards} slabs, the process group "
            f"{comm.world_size()} ranks")
    slabs = spatial_slabs(state, spec)
    return _local_state(slabs[comm.rank()], state.step,
                        comm.rank_device(device))


def spatial_gather_state(loc: State) -> State:
    """The global State of the per-slab ones, on every rank: each field
    all-gathered in rank order (the reference's reshape order).  Slot
    order is per slab: compare by invariants, not bitwise.  Of the
    DP-sharded states too: there it is the capacity-padded global state."""
    return State(step=loc.step.clone(),
                 **{k: comm.all_gather(getattr(loc, k)) for k in _ARRAYS})


F_GHOST = 6   # ghost payload: x3 | v3 (2D pads) | valid
F_MIG = 11    # migration:     x3 | v3 | acc3 | kind | emit_step | valid


def _pack_payload(x, v, d):
    z = x.new_zeros((x.shape[0], 3 - d))
    return torch.cat([x, z, v, z], dim=1)


def _pack_mig(x, v, acc, kind, emit, d):
    z = x.new_zeros((x.shape[0], 3 - d))
    # emit_step travels bitcast to float32, not value-cast: int32 steps
    # above 2^24 would round.  The buffer is only gathered and sent, never
    # computed on, so its bit patterns arrive intact.
    return torch.cat([x, z, v, z, acc, z, kind[:, None].to(x.dtype),
                      emit.contiguous().view(torch.float32)[:, None]], dim=1)


def _with_valid(buf, valid):
    return torch.cat([buf, valid[:, None].to(buf.dtype)], dim=1)


def _ghost_buffer(x, v, idx, valid, d):
    """The ghost send buffer [cap, F_GHOST + 1] of the particles `idx`:
    x | v | valid, zero rows past the selection."""
    return _with_valid(_pack_payload(_gather_rows(x, idx),
                                     _gather_rows(v, idx), d), valid)


def _mig_buffer(x, v, acc, kind, emit, idx, valid, d):
    """The migration send buffer [cap, F_MIG + 1] of the particles `idx`:
    x | v | acc | kind | emit_step bits | valid."""
    rows = [_gather_rows(t, idx) for t in (x, v, acc, kind, emit)]
    return _with_valid(_pack_mig(*rows, d), valid)


def _slab_geometry(scene: Scene, spec: SpatialSpec, grid, me: int):
    """(my_lo, my_hi, ci_offset) of rank `me`, in the reference's float32
    arithmetic: a face an ulp off would change which particles are ghosts
    or migrants.  `ci_offset` places the slab-local lattice: local cell 0
    is global cell k_dev, chosen so [my_lo − h − ε, my_hi + h + ε] is
    covered, clamped inside the global lattice."""
    my_lo = np.float32(spec.slab_lo) + np.float32(me) * np.float32(spec.slab_w)
    my_hi = my_lo + np.float32(spec.slab_w)
    if grid is None:
        return my_lo, my_hi, None
    ax = spec.axis
    s_full = neighbors.GridSpec.for_scene(scene).shape[ax]
    h, cell, lo = (np.float32(a) for a in (scene.params.h, grid.cell,
                                            grid.lo[ax]))
    k_dev = int(np.floor((my_lo - h - cell - lo) / cell))
    k_dev = min(max(k_dev, 0), s_full - grid.shape[ax])
    ci_off = tuple(k_dev if a == ax else 0 for a in range(len(grid.shape)))
    return my_lo, my_hi, ci_off


def _drop_set(a: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor):
    """a with a[slot] = vals, rows whose slot is len(a) dropped (they go to
    one spare row that is cut off)."""
    ext = torch.cat([a, a.new_zeros((1,) + tuple(a.shape[1:]))])
    ext.index_put_((slot,), vals)
    return ext[:-1]


def _make_spatial_local(scene: Scene, spec: SpatialSpec, method: str = "grid"):
    """The per-rank slab step: st → (st, local overflow count [] i32)."""
    if method not in ("naive", "grid", "pallas"):
        raise ValueError(f"unknown neighbor method {method!r}")
    params = scene.params
    dt = params.dt
    ax = spec.axis
    h = params.h
    leap = params.integrator == "leapfrog"
    grid = None
    if method in ("grid", "pallas"):
        # slab-local lattice: grid and slot memory scale 1/n_shards
        grid = neighbors.GridSpec.for_slab(scene, spec.slab_w, ax)
    me = comm.rank()
    is_first, is_last = me == 0, me == spec.n_shards - 1
    my_lo, my_hi, ci_off = _slab_geometry(scene, spec, grid, me)
    h32 = np.float32(h)
    lo_band, hi_band = float(my_lo + h32), float(my_hi - h32)
    my_lo, my_hi = float(my_lo), float(my_hi)
    nl = spec.cap_local

    def local(st: State):
        d = st.x.shape[1]
        active = st.active
        movable = active & (st.kind == 0)
        mov = movable[:, None].to(st.x.dtype)
        x, v, acc = st.x, st.v, st.acc
        if leap:
            # KDK: the half-kick and drift come before the ghost exchange,
            # so the ghosts carry post-drift positions
            v = v + (0.5 * dt) * acc * mov
            x = x + dt * v * mov

        # (a) ghosts: particles within h of each interior face; the sends
        # at domain walls are masked, and so are the receipts
        near_lo = active & (x[:, ax] < lo_band) & (not is_first)
        near_hi = active & (x[:, ax] >= hi_band) & (not is_last)
        idx_lo, val_lo, ov1 = _pack_idx(near_lo, spec.cap_ghost)
        idx_hi, val_hi, ov2 = _pack_idx(near_hi, spec.cap_ghost)
        g_from_right, g_from_left = comm.ring_exchange(
            _ghost_buffer(x, v, idx_lo, val_lo, d),
            _ghost_buffer(x, v, idx_hi, val_hi, d))
        gl_valid = (g_from_left[:, F_GHOST] > 0) & (not is_first)
        gr_valid = (g_from_right[:, F_GHOST] > 0) & (not is_last)

        def unpack_ghost(g, valid):
            gx = torch.where(valid[:, None], g[:, 0:d], 1e18)
            return gx, torch.where(valid[:, None], g[:, 3:3 + d], 0.0)

        glx, glv = unpack_ghost(g_from_left, gl_valid)
        grx, grv = unpack_ghost(g_from_right, gr_valid)
        cx = torch.cat([x, glx, grx])
        cv = torch.cat([v, glv, grv])
        c_act = torch.cat([active, gl_valid, gr_valid])

        # (b) density over locals + h-deep ghosts: the locals' support is
        # complete; the ghosts' own rho is truncated, so their true (rho, p)
        # comes from their owners before the force pass
        split_ctx = None
        if method == "grid":
            rho_c = neighbors.grid_density(cx, c_act, params, grid,
                                           ci_offset=ci_off)
        elif method == "pallas":
            split_ctx = pallas_step.pallas_split_build(
                cx, cv, c_act, params, grid, ci_offset=ci_off)
            rho_c = pallas_step.pallas_density_split(split_ctx, params)
        else:
            rho_c = physics.density_naive(cx, c_act, params)
        rho = rho_c[:nl]
        p = physics.eos_pressure(rho, params)

        # the same face particles in the same packed order
        rp = torch.stack([rho, p], dim=1)
        rp_from_right, rp_from_left = comm.ring_exchange(
            _gather_rows(rp, idx_lo), _gather_rows(rp, idx_hi))
        ghost_rho = torch.cat([
            torch.where(gl_valid, rp_from_left[:, 0], 1.0),
            torch.where(gr_valid, rp_from_right[:, 0], 1.0),
        ])
        ghost_p = torch.cat([
            torch.where(gl_valid, rp_from_left[:, 1], 0.0),
            torch.where(gr_valid, rp_from_right[:, 1], 0.0),
        ])
        rho_cc = torch.cat([rho, ghost_rho])
        p_cc = torch.cat([p, ghost_p])

        # (b') forces with the ghosts' rho/p
        if method == "grid":
            f_c = neighbors.grid_forces(cx, cv, rho_cc, p_cc, c_act, params,
                                        grid, ci_offset=ci_off)
        elif method == "pallas":
            f_c = pallas_step.pallas_forces_split(split_ctx, rho_cc, p_cc,
                                                  params, d)
        else:
            f_c = physics.forces_naive(cx, cv, rho_cc, p_cc, c_act, params)
        f = f_c[:nl] + physics.gravity_force(rho, params)
        if params.boundary_mode == "penalty":
            f = f + physics.wall_penalty_force(x, v, scene.lo, scene.hi,
                                               params)
        if scene.force_fields:
            f = f + physics.force_field_force(x, st.step, scene.force_fields)

        # (c) integrate the locals
        a = f / torch.clamp(rho, min=1e-12)[:, None]
        if leap:
            v = v + (0.5 * dt) * a * mov
        else:
            v = v + dt * a * mov
            x = x + dt * v * mov
        acc = torch.where(movable[:, None], a, 0.0)
        if params.boundary_mode == "clamp":
            xc, vc = physics.clamp_boundary(x, v, scene.lo, scene.hi, params)
            x = torch.where(movable[:, None], xc, x)
            v = torch.where(movable[:, None], vc, v)

        # (d) migration across interior faces (domain walls keep theirs)
        go_left = active & (x[:, ax] < my_lo) & (not is_first)
        go_right = active & (x[:, ax] >= my_hi) & (not is_last)
        leaver = go_left | go_right
        idx_ml, val_ml, ov3 = _pack_idx(go_left, spec.cap_mig)
        idx_mh, val_mh, ov4 = _pack_idx(go_right, spec.cap_mig)
        cols = (x, v, acc, st.kind, st.emit_step)
        m_from_right, m_from_left = comm.ring_exchange(
            _mig_buffer(*cols, idx_ml, val_ml, d),
            _mig_buffer(*cols, idx_mh, val_mh, d))
        mr_valid = (m_from_right[:, F_MIG] > 0) & (not is_last)
        ml_valid = (m_from_left[:, F_MIG] > 0) & (not is_first)
        incoming = torch.cat([m_from_left, m_from_right])
        inc_valid = torch.cat([ml_valid, mr_valid])

        # park the leavers only: pending emitter slots keep their spawn
        # state until they activate
        x = torch.where(leaver[:, None], -1e6, x)
        v = torch.where(leaver[:, None], 0.0, v)
        acc = torch.where(leaver[:, None], 0.0, acc)
        emit = torch.where(leaver, int(INACTIVE), st.emit_step)

        # arrivals take INACTIVE slots only, valid arrival #r the free
        # slot #r
        n_free = 2 * spec.cap_mig
        free_idx = _pack_idx(emit == int(INACTIVE), n_free)[0]
        rank = torch.cumsum(inc_valid, 0, dtype=torch.int64) - 1
        take = free_idx[torch.clamp(rank, 0, n_free - 1)]
        slot = torch.where(inc_valid, take, nl)
        ins_overflow = torch.sum(inc_valid & (take >= nl), dtype=torch.int32)
        x = _drop_set(x, slot, incoming[:, 0:d])
        v = _drop_set(v, slot, incoming[:, 3:3 + d])
        acc = _drop_set(acc, slot, incoming[:, 6:6 + d])
        kind = _drop_set(st.kind, slot, incoming[:, 9].to(torch.int32))
        emit = _drop_set(emit, slot,
                         incoming[:, 10].contiguous().view(torch.int32))

        overflow = ov1 + ov2 + ov3 + ov4 + ins_overflow
        if split_ctx is not None:
            # cell-cap and row-cap drops of the slot lattice too
            overflow = overflow + split_ctx.addr.overflow
        return State(
            x=x, v=v, acc=acc,
            rho=torch.where(active, rho, st.rho),
            p=torch.where(active, p, st.p),
            kind=kind, emit_step=emit, step=st.step + 1,
        ), overflow

    return local


def make_spatial_step(scene: Scene, spec: SpatialSpec, method: str = "grid"):
    """One slab step: loc → (loc, overflow summed over ranks [] i32)."""
    local = _make_spatial_local(scene, spec, method)

    def step(loc: State):
        out, over = local(loc)
        return out, comm.all_reduce_sum(over)

    return step


def make_spatial_advance(
    scene: Scene,
    spec: SpatialSpec,
    method: str = "grid",
    steps_per_dispatch: int = 50,
    sort_every: int = 1,
    slot_resident: bool = False,
    auto_rebuild: bool = False,
):
    """`steps_per_dispatch` slab steps: loc → (loc, worst) where worst is
    the largest over the steps of the overflow summed over ranks ([] i32
    on the device, the same on every rank; > 0 means a ghost, migration,
    local or slot cap dropped particles and the dispatch's physics is not
    to be trusted).  The per-step counts are summed over ranks in one
    all-reduce at the end of the dispatch.  `sort_every > 1`,
    `slot_resident` and `auto_rebuild` are the slab fast path (ROADMAP.md
    Queue 1 item 14.3)."""
    if slot_resident and sort_every <= 1:
        raise ValueError("slot_resident requires sort_every > 1")
    if auto_rebuild and not slot_resident:
        raise ValueError("auto_rebuild requires slot_resident=True")
    if sort_every > 1:
        raise _not_ported("sort_every > 1 with shards (the slab fast path)",
                          "14.3")
    local = _make_spatial_local(scene, spec, method)

    def advance(loc: State):
        overs = []
        for _ in range(steps_per_dispatch):
            loc, over = local(loc)
            overs.append(over)
        worst = torch.max(comm.all_reduce_sum(torch.stack(overs)))
        return loc, worst

    return advance


class SpatialCapOverflow(RuntimeError):
    """A slab dispatch overflowed a static buffer (ghost, migration, local
    or slot cap) on the per-step path: the SpatialSpec is too small for the
    state.  Callers recover by rebuilding the spec from the gathered state
    (`SpatialSpec.for_state`), as `step.run(shards=)` does."""


def make_audited_spatial_advance(
    scene: Scene,
    spec: SpatialSpec,
    method: str = "pallas",
    steps_per_dispatch: int = 100,
    sort_every: int = 1,
    slot_resident: bool = False,
    auto_rebuild: bool = True,
):
    """`advance(loc) -> loc` on the per-step slab path, raising
    SpatialCapOverflow when a dispatch overflowed.  The decision is taken
    on the overflow summed over ranks, so every rank raises together (one
    rank raising alone would leave the others waiting in a collective).
    The fast path's fallback, heal and demotion (`sort_every > 1`) come
    with ROADMAP.md Queue 1 item 14.3; `auto_rebuild` applies only there.
    Carries the reference's observability attributes (`healed`,
    `repaired`, `mode`)."""
    adv = make_spatial_advance(scene, spec, method, steps_per_dispatch,
                               sort_every=sort_every,
                               slot_resident=slot_resident)

    def audited(loc: State) -> State:
        out, worst = adv(loc)
        worst = int(worst)
        if worst:
            raise SpatialCapOverflow(
                f"spatial dispatch at step {int(loc.step)} overflowed a "
                f"static buffer even on the per-step path (worst={worst}); "
                f"rebuild the SpatialSpec from the current state "
                f"(SpatialSpec.for_state)")
        return out

    audited.healed = 0
    audited.repaired = 0
    audited.mode = "resident"
    return audited
