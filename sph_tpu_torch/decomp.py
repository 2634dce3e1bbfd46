"""Domain decomposition on `torch.distributed` (port of
`sph_tpu/decomp.py`: the particle-DP step, the per-step slabs, the slab
fast path and the pencils).

One process per rank (SPMD): rank r holds only its own part of the state,
as `State` tensors of `[cap_local, ...]`, exactly the reference's row r of
its `[n, cap_local, ...]` stack under `shard_map`.  The collectives are
the four of `comm.py`; every rank issues the same ones in the same order,
and every branch the host takes is taken on a value all-reduced over the
ranks, so every rank takes it.

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

3. The slab fast path (`sort_every > 1`, pallas): blocks of `sort_every`
   steps that pin the ghost selection (h + skin deep) and the addressing
   on the skinned slab-local lattice, exchange the pinned ghosts' (x, v)
   and (rho, p) every step, and migrate at the block end
   (`_make_spatial_reuse_local`); `slot_resident` integrates each block in
   the slot arrays (`_SlabSlots`: the single-device slot-space block
   `step._slot_steps`, K1/K2 through `_call_density` / `_call_force`, with
   the slab's ghost exchanges as hooks); `auto_rebuild` keeps the
   residency across blocks, rebuilding on the mesh-wide predicate or an
   emitter activation, with in-dispatch heal on the per-step slab step and
   interior-only minority repair (`_make_spatial_resident_auto`).
   `make_audited_spatial_advance` re-runs a violating dispatch exactly on
   the per-step slabs and demotes a flow that heals every block.

4. `make_pencil_advance`, pencils: the domain cut along two axes into
   n1 × n2 parts on a `comm.RankGrid` of the ranks, a ring along each
   axis.  The slab step's phases run once per cut axis, axis 1 then axis
   2 (`_make_local` with two faces): the axis-2 ghosts are selected from
   the locals and the fresh axis-1 ghosts, so corner ghosts arrive by two
   hops; the (rho, p) re-import forwards the phase-1-corrected values in
   phase 2; migration inserts along axis 1, then runs axis 2 over the
   updated arrays.  Per step only, as in the reference.

Compactions are padded and stay on the device (no `nonzero`): a selected
row past a buffer's capacity is counted as overflow, and the overflow
counts are summed over ranks once per dispatch.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

from sph_tpu_torch import comm, neighbors, pallas_step, physics, slot_pass
from sph_tpu_torch import step as step_mod
from sph_tpu_torch.params import Scene
from sph_tpu_torch.state import _FIELDS, INACTIVE, State

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


def _part(xa: np.ndarray, lo: float, w: float, n: int) -> np.ndarray:
    """The part (0..n−1) of each coordinate `xa` in n parts of width w
    from lo, the outer ones open-ended."""
    return np.clip(((xa - lo) // w).astype(int), 0, n - 1)


def _slab_of(x: np.ndarray, spec: SpatialSpec) -> np.ndarray:
    return _part(x[:, spec.axis], spec.slab_lo, spec.slab_w, spec.n_shards)


def spatial_slabs(state, spec: SpatialSpec) -> list[dict]:
    """Host-side split of a global state into the per-slab arrays
    ({field: [cap_local, ...]} for each slab): live slots (active, or
    scheduled to activate: pending emitter slots go to the slab of their
    spawn position) in their order, then pads parked at −1e6 with
    emit_step INACTIVE and rho 1."""
    return _split(state, lambda x: _slab_of(x, spec), spec.n_shards,
                  spec.cap_local, "slab")


def _split(state, owner_of, n_parts: int, cap_local: int,
           what: str) -> list[dict]:
    """`state`'s live slots by part, `owner_of(x)` the part of each slot,
    each part padded to `cap_local` (`spatial_slabs`)."""
    x = _host(state.x)
    owner = owner_of(x)
    live = _host(state.emit_step) != int(INACTIVE)
    fields = {k: _host(getattr(state, k)) for k in _ARRAYS}
    park = x.min(axis=0) * 0 + np.float32(-1e6)
    out = []
    for s in range(n_parts):
        sel = live & (owner == s)
        cnt = int(sel.sum())
        if cnt > cap_local:
            raise ValueError(
                f"{what} {s} holds {cnt} > cap_local {cap_local}")
        pad = cap_local - cnt
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


def _faces(scene: Scene, grid, axis: int, lo: float, w: float, i: int,
           skin: float = 0.0):
    """(my_lo, my_hi, k_dev) of part `i` along `axis` (parts of width w
    from lo), in the reference's float32 arithmetic: a face an ulp off
    would change which particles are ghosts or migrants.  k_dev places the
    rank-local lattice along `axis`: local cell 0 is global cell k_dev,
    chosen so [my_lo − h_eff − ε, my_hi + h_eff + ε] is covered (h_eff = h
    + skin, the fast path's Verlet skin), clamped inside the global
    lattice (None without a lattice)."""
    my_lo = np.float32(lo) + np.float32(i) * np.float32(w)
    my_hi = my_lo + np.float32(w)
    if grid is None:
        return my_lo, my_hi, None
    s_full = neighbors.GridSpec.for_scene(scene, skin=skin).shape[axis]
    h, cell, glo = (np.float32(a) for a in (scene.params.h + skin, grid.cell,
                                             grid.lo[axis]))
    k_dev = int(np.floor((my_lo - h - cell - glo) / cell))
    return my_lo, my_hi, min(max(k_dev, 0), s_full - grid.shape[axis])


def _slab_geometry(scene: Scene, spec: SpatialSpec, grid, me: int,
                   skin: float = 0.0):
    """(my_lo, my_hi, ci_offset) of rank `me`'s slab (`_faces` along the
    slab axis; ci_offset 0 on the other axes)."""
    my_lo, my_hi, k_dev = _faces(scene, grid, spec.axis, spec.slab_lo,
                                 spec.slab_w, me, skin)
    if grid is None:
        return my_lo, my_hi, None
    ci_off = tuple(k_dev if a == spec.axis else 0
                   for a in range(len(grid.shape)))
    return my_lo, my_hi, ci_off


@dataclasses.dataclass(frozen=True)
class _Slab:
    """This rank's slab, or one cut axis of its pencil: its faces (float32
    values held as Python floats), its lattice's `ci_offset` and its ring
    neighbors along the axis (`peers`, None for the world's ring).  The
    first and last part's outer faces are domain walls: nothing is sent or
    migrates across them."""

    axis: int
    first: bool
    last: bool
    lo: float
    hi: float
    ci_off: tuple | None
    peers: tuple | None = None

    def ring(self, to_left, to_right):
        """`comm.ring_exchange` along this axis's ring."""
        return comm.ring_exchange(to_left, to_right, self.peers)

    def bands(self, x, depth: float):
        """(near_lo, near_hi): x within `depth` of each interior face, the
        depth added in float32 as the reference adds it."""
        xa = x[:, self.axis]
        lo = float(np.float32(self.lo) + np.float32(depth))
        hi = float(np.float32(self.hi) - np.float32(depth))
        return (xa < lo) & (not self.first), (xa >= hi) & (not self.last)

    def beyond(self, xa):
        """xa past an interior face (`go_left`, `go_right` of a leaver)."""
        return (((xa < self.lo) & (not self.first)),
                ((xa >= self.hi) & (not self.last)))

    def face_margin(self, xa):
        """Distance to the nearest interior face (inf at a domain wall)."""
        inf = torch.full_like(xa, float("inf"))
        return torch.minimum(inf if self.first else xa - self.lo,
                             inf if self.last else self.hi - xa)


def _slab(scene: Scene, spec: SpatialSpec, grid, skin: float = 0.0) -> _Slab:
    me = comm.rank()
    my_lo, my_hi, ci_off = _slab_geometry(scene, spec, grid, me, skin)
    return _Slab(axis=spec.axis, first=me == 0,
                 last=me == spec.n_shards - 1, lo=float(my_lo),
                 hi=float(my_hi), ci_off=ci_off)


def _drop_set(a: torch.Tensor, slot: torch.Tensor, vals: torch.Tensor):
    """a with a[slot] = vals, rows whose slot is len(a) dropped (they go to
    one spare row that is cut off)."""
    ext = torch.cat([a, a.new_zeros((1,) + tuple(a.shape[1:]))])
    ext.index_put_((slot,), vals)
    return ext[:-1]


# The reference chains its ppermutes with `_chained` (an XLA optimization
# barrier) so that the compiler cannot reorder them across devices; here
# every rank issues its collectives in program order, so no token is needed.


def _exchange_ghosts(slab: _Slab, x, v, idx_lo, val_lo, idx_hi, val_hi):
    """Send the face particles `idx_lo` left and `idx_hi` right; returns the
    2·cap_ghost received ghosts (the left neighbor's, then the right's):
    (gx, gv, g_valid), invalid rows far away with v 0.  Receipts at the
    domain walls are masked too."""
    d = x.shape[1]
    g_from_right, g_from_left = slab.ring(
        _ghost_buffer(x, v, idx_lo, val_lo, d),
        _ghost_buffer(x, v, idx_hi, val_hi, d))
    g = torch.cat([g_from_left, g_from_right])
    n = g_from_left.shape[0]
    valid = g[:, F_GHOST] > 0
    valid = torch.cat([valid[:n] & (not slab.first),
                       valid[n:] & (not slab.last)])
    gx = torch.where(valid[:, None], g[:, 0:d], 1e18)
    return gx, torch.where(valid[:, None], g[:, 3:3 + d], 0.0), valid


def _ghost_rho_p(slab: _Slab, rho, p, idx_lo, idx_hi, g_valid):
    """The ghosts' (rho, p) from their owners, for the same face particles
    in the same packed order as the (x, v) exchange; invalid ghosts rho 1,
    p 0."""
    rp = torch.stack([rho, p], dim=1)
    rp_from_right, rp_from_left = slab.ring(
        _gather_rows(rp, idx_lo), _gather_rows(rp, idx_hi))
    g = torch.cat([rp_from_left, rp_from_right])
    return (torch.where(g_valid, g[:, 0], 1.0),
            torch.where(g_valid, g[:, 1], 0.0))


def _integrate(scene: Scene, x, v, rho, f, step, mov, movable):
    """Body forces, then the integrator's update of the locals' (x, v) and
    the new acc, then the clamp boundary: the per-step step's arithmetic."""
    params = scene.params
    dt = params.dt
    f = f + physics.gravity_force(rho, params)
    if params.boundary_mode == "penalty":
        f = f + physics.wall_penalty_force(x, v, scene.lo, scene.hi, params)
    if scene.force_fields:
        f = f + physics.force_field_force(x, step, scene.force_fields)
    a = f / torch.clamp(rho, min=1e-12)[:, None]
    if params.integrator == "leapfrog":
        v = v + (0.5 * dt) * a * mov
    else:
        v = v + dt * a * mov
        x = x + dt * v * mov
    acc = torch.where(movable[:, None], a, 0.0)
    if params.boundary_mode == "clamp":
        xc, vc = physics.clamp_boundary(x, v, scene.lo, scene.hi, params)
        x = torch.where(movable[:, None], xc, x)
        v = torch.where(movable[:, None], vc, v)
    return x, v, acc


def _migrate(slab: _Slab, spec: SpatialSpec, x, v, acc, kind, emit, active):
    """Migration across the interior faces: the particles of `active` past
    a face are sent to that neighbor and parked here (INACTIVE; pending
    emitter slots keep their spawn state), and the arrivals take INACTIVE
    slots only, valid arrival #r the free slot #r.  Returns (x, v, acc,
    kind, emit, overflow): leavers and arrivals the buffers or the free
    slots could not hold."""
    d, nl = x.shape[1], x.shape[0]
    go_left, go_right = slab.beyond(x[:, slab.axis])
    go_left, go_right = go_left & active, go_right & active
    leaver = go_left | go_right
    idx_ml, val_ml, ov3 = _pack_idx(go_left, spec.cap_mig)
    idx_mh, val_mh, ov4 = _pack_idx(go_right, spec.cap_mig)
    cols = (x, v, acc, kind, emit)
    m_from_right, m_from_left = slab.ring(
        _mig_buffer(*cols, idx_ml, val_ml, d),
        _mig_buffer(*cols, idx_mh, val_mh, d))
    mr_valid = (m_from_right[:, F_MIG] > 0) & (not slab.last)
    ml_valid = (m_from_left[:, F_MIG] > 0) & (not slab.first)
    incoming = torch.cat([m_from_left, m_from_right])
    inc_valid = torch.cat([ml_valid, mr_valid])

    x = torch.where(leaver[:, None], -1e6, x)
    v = torch.where(leaver[:, None], 0.0, v)
    acc = torch.where(leaver[:, None], 0.0, acc)
    emit = torch.where(leaver, int(INACTIVE), emit)

    n_free = 2 * spec.cap_mig
    free_idx = _pack_idx(emit == int(INACTIVE), n_free)[0]
    rank = torch.cumsum(inc_valid, 0, dtype=torch.int64) - 1
    take = free_idx[torch.clamp(rank, 0, n_free - 1)]
    slot = torch.where(inc_valid, take, nl)
    ins_overflow = torch.sum(inc_valid & (take >= nl), dtype=torch.int32)
    x = _drop_set(x, slot, incoming[:, 0:d])
    v = _drop_set(v, slot, incoming[:, 3:3 + d])
    acc = _drop_set(acc, slot, incoming[:, 6:6 + d])
    kind = _drop_set(kind, slot, incoming[:, 9].to(torch.int32))
    emit = _drop_set(emit, slot,
                     incoming[:, 10].contiguous().view(torch.int32))
    return x, v, acc, kind, emit, ov3 + ov4 + ins_overflow


def _make_spatial_local(scene: Scene, spec: SpatialSpec, method: str = "grid"):
    """The per-rank slab step: st → (st, local overflow count [] i32)."""
    grid = None
    if method in ("grid", "pallas"):
        # slab-local lattice: grid and slot memory scale 1/n_shards
        grid = neighbors.GridSpec.for_slab(scene, spec.slab_w, spec.axis)
    slab = _slab(scene, spec, grid)
    return _make_local(scene, spec, (slab,), slab.ci_off, grid, method)


def _make_local(scene: Scene, spec, faces: tuple, ci_off, grid,
                method: str):
    """The per-rank step of slabs (one face) and pencils (two, axis 1 then
    axis 2): st → (st, local overflow count [] i32).  Each of steps (a),
    (b)'s re-import and (d) runs once per face in that order, over what
    the previous face left, so a pencil's corner ghosts and diagonal
    migrants make two hops."""
    if method not in ("naive", "grid", "pallas"):
        raise ValueError(f"unknown neighbor method {method!r}")
    params = scene.params
    dt = params.dt
    leap = params.integrator == "leapfrog"
    nl, gc = spec.cap_local, spec.cap_ghost

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

        # (a) ghosts: the particles within h of each interior face, of the
        # locals and (pencils' axis 2) the ghosts already received
        cx, cv, c_act = x, v, active
        overflow = torch.zeros((), dtype=torch.int32, device=x.device)
        sent = []
        for face in faces:
            near_lo, near_hi = face.bands(cx, params.h)
            idx_lo, val_lo, ov1 = _pack_idx(c_act & near_lo, gc)
            idx_hi, val_hi, ov2 = _pack_idx(c_act & near_hi, gc)
            gx, gv, g_valid = _exchange_ghosts(face, cx, cv, idx_lo, val_lo,
                                               idx_hi, val_hi)
            sent.append((idx_lo, idx_hi, g_valid))
            cx = torch.cat([cx, gx])
            cv = torch.cat([cv, gv])
            c_act = torch.cat([c_act, g_valid])
            overflow = overflow + ov1 + ov2

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
        # the re-import in the ghosts' order: a pencil's phase 2 forwards
        # the phase-1-corrected values, so corner ghosts get their owner's
        # (rho, p)
        rho_cc, p_cc = rho, p
        for face, (idx_lo, idx_hi, g_valid) in zip(faces, sent):
            ghost_rho, ghost_p = _ghost_rho_p(face, rho_cc, p_cc, idx_lo,
                                              idx_hi, g_valid)
            rho_cc = torch.cat([rho_cc, ghost_rho])
            p_cc = torch.cat([p_cc, ghost_p])

        # (b') forces with the ghosts' rho/p
        if method == "grid":
            f_c = neighbors.grid_forces(cx, cv, rho_cc, p_cc, c_act, params,
                                        grid, ci_offset=ci_off)
        elif method == "pallas":
            f_c = pallas_step.pallas_forces_split(split_ctx, rho_cc, p_cc,
                                                  params, d)
        else:
            f_c = physics.forces_naive(cx, cv, rho_cc, p_cc, c_act, params)

        # (c) integrate the locals, (d) migrate across interior faces: a
        # pencil's axis 2 over the arrays axis 1 left, so a particle past
        # both faces reaches its diagonal owner in the same step
        x, v, acc = _integrate(scene, x, v, rho, f_c[:nl], st.step, mov,
                               movable)
        kind, emit = st.kind, st.emit_step
        for face in faces:
            x, v, acc, kind, emit, ov_m = _migrate(
                face, spec, x, v, acc, kind, emit, emit <= st.step)
            overflow = overflow + ov_m
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


# ---------------------------------------------------------------------------
# 3. The slab fast path: Verlet-skin reuse, slot-resident blocks, auto-rebuild
# ---------------------------------------------------------------------------


def _fast_grid(scene: Scene, spec: SpatialSpec, skin: float):
    """The fast path's slab-local lattice: cells of edge h + skin at the
    scene's default cap, the slot grid over it, and this rank's slab."""
    base = neighbors.GridSpec.for_scene(scene)
    grid = neighbors.GridSpec.for_slab(scene, spec.slab_w, spec.axis,
                                       cap=base.cap, skin=skin)
    # the reference's batch_skip (emitter scenes) changes scheduling only;
    # the port's kernels skip empty slots anyway
    return grid, pallas_step.slot_grid(grid), _slab(scene, spec, grid, skin)


class _SlabSlots:
    """A slab's slot residency: its locals and the ghosts its neighbors
    sent, in the slot arrays [c_rows, C, lanes] of the skinned slab-local
    lattice, integrated there for whole blocks by the single-device
    `step._slot_steps` with the slab's hooks.  Each step only the pinned
    face particles' (x, v) and, between K1 and K2, the faces' (rho, p)
    cross to the neighbors: gathered from slot rows by the owner, scattered
    into the ghost slots by the receiver.  The pins (`pins`) are slot
    indices of one addressing: valid only until the next build or repair.
    One per device, made on the first block."""

    def __init__(self, scene: Scene, spec: SpatialSpec, grid, sg,
                 slab: _Slab, skin: float, sort_every: int, device):
        self.spec, self.grid, self.sg, self.slab = spec, grid, sg, slab
        self.sort_every = sort_every
        self.params = params = scene.params
        self.d = d = params.dim
        self.leap = params.integrator == "leapfrog"
        self.sp = step_mod._SlotPhysics(scene, grid, sg, device)
        self.half2 = (0.5 * skin) ** 2
        self.zg = torch.zeros((spec.cap_ghost, 3 - d), device=device)
        self.cols = torch.arange(3, device=device)

    def build(self, x, v, act0, movable0, ghosts, use_mem: bool) -> dict:
        """Addressing and scatter over the locals and the received ghosts
        (`_exchange_ghosts`): `step._scatter_residency` on the slab-local
        lattice, the ghosts not movable."""
        gx, gv, g_valid = ghosts
        return step_mod._scatter_residency(
            torch.cat([x, gx]), torch.cat([v, gv]),
            torch.cat([act0, g_valid]),
            torch.cat([movable0, torch.zeros_like(g_valid)]),
            self.grid, self.sg, use_mem, self.slab.ci_off)

    def pins(self, addr, idx_lo, val_lo, idx_hi, val_hi) -> dict:
        """The block's pinned slot indices: each ghost's slot (`okg`: it has
        one), and each face particle's slot with its send flag."""
        nl = self.spec.cap_local
        ok = addr.ok()
        okg = ok[nl:]
        zero = torch.zeros((), dtype=addr.pos.dtype, device=ok.device)

        def face(idx, val):
            safe = torch.clamp(idx, max=nl - 1)
            okf = (idx < nl) & ok[safe]
            return dict(row=torch.where(okf, addr.row_pos[safe], zero).long(),
                        pos=torch.where(okf, addr.pos[safe], zero).long(),
                        okf=okf, send=val & okf)

        return dict(okg=okg,
                    row=torch.where(okg, addr.row_pos[nl:], zero).long(),
                    pos=torch.where(okg, addr.pos[nl:], zero).long(),
                    lo=face(idx_lo, val_lo), hi=face(idx_hi, val_hi))

    def _at(self, slot, f, ncols):
        """[n, ncols] values of the face slots `f` (masked rows read row 0)."""
        return slot[f["row"][:, None], self.cols[None, :ncols],
                    f["pos"][:, None]]

    def face_buffer(self, xs, vs, f):
        """The ghost send buffer of a pinned face from the slot arrays:
        x | v | send flag (x far, v 0 where the particle has no slot)."""
        okf = f["okf"][:, None]
        d = self.d
        return torch.cat([torch.where(okf, self._at(xs, f, d), 1e18), self.zg,
                          torch.where(okf, self._at(vs, f, d), 0.0), self.zg,
                          f["send"][:, None].to(xs.dtype)], dim=1)

    def _put_ghosts(self, slot, pins, vals):
        """slot's ghost slots = vals [2·cap_ghost, C], in place; a ghost
        with no slot writes the dummy row's own value back to it."""
        ncols = vals.shape[1]
        keep = torch.where(pins["okg"][:, None], vals,
                           slot[0, :ncols, 0][None, :])
        slot.index_put_((pins["row"][:, None], self.cols[None, :ncols],
                         pins["pos"][:, None]), keep)

    def exchange(self, xs, vs, pins):
        """The step's ghost exchange in slot space: send the pinned faces'
        (x, v), write the received ones into the ghost slots (in place)."""
        g_from_right, g_from_left = self.slab.ring(
            self.face_buffer(xs, vs, pins["lo"]),
            self.face_buffer(xs, vs, pins["hi"]))
        g = torch.cat([g_from_left, g_from_right])
        self._put_ghosts(xs, pins, g[:, 0:self.d])
        self._put_ghosts(vs, pins, g[:, 3:3 + self.d])

    def steps(self, c, use_mem: bool, budget=None, store=None):
        """`step._slot_steps` from the carry `c` (addr, xs, vs, acc, movb,
        x0s, refs, jb, pins, step0, drifted): each step's drift exchanges
        the pinned faces' (x, v) into the ghost slots (not step 0 of a
        `drifted` carry: its build had them), K1's rp gets the faces'
        (rho, p) before K2, and with `use_mem` the drift audit is relaxed
        by cell membership except past a slab face; with a `budget` the
        block's end also counts the membership rebuild predicate's slots,
        the face distance its extra margin; `store`: the dispatch's
        `slot_pass.SlotStore` (the ghosts are particles of the addressing,
        so their slots lie in the occupied groups).  Returns (xs, vs, acc,
        rp, viol, risky)."""
        pins, slab = c["pins"], self.slab

        def rp_hook(rp):
            rp_from_right, rp_from_left = slab.ring(
                self.rp_face(rp, pins["lo"]), self.rp_face(rp, pins["hi"]))
            self._put_ghosts(rp, pins, torch.cat([rp_from_left,
                                                  rp_from_right]))

        return step_mod._slot_steps(
            self.sp, c, self.sort_every, self.half2, use_mem, self.leap,
            exchange=lambda xs, vs: self.exchange(xs, vs, pins),
            rp_hook=rp_hook, ci_offset=slab.ci_off, faces=slab,
            budget=budget, store=store)

    def rp_face(self, rp, f):
        """The (rho, p) of a pinned face from K1's rp (rest density and 0
        where the particle has no slot)."""
        v = self._at(rp, f, 2)
        okf = f["okf"]
        return torch.stack([torch.where(okf, v[:, 0], self.params.rest_density),
                            torch.where(okf, v[:, 1], 0.0)], dim=1)


def _slab_slots(scene: Scene, spec: SpatialSpec, grid, sg, slab: _Slab,
                skin: float, sort_every: int):
    """device → that device's `_SlabSlots`, made on first use."""
    return functools.lru_cache(maxsize=None)(functools.partial(
        _SlabSlots, scene, spec, grid, sg, slab, skin, sort_every))


def _make_spatial_reuse_local(scene: Scene, spec: SpatialSpec,
                              sort_every: int, slot_resident: bool = False):
    """The per-rank BLOCK of the slab fast path (pallas): `sort_every`
    steps with the Verlet-skin contract of the single-device reuse path,
    extended across ranks.  block(st) → (st, local overflow [] i32).

    Pinned per block, from the block-top positions: the ghost SELECTION
    (faces within h + skin: every particle drifts < skin/2 within the
    block, so the pinned set stays a superset of each step's h-band, and
    the extras beyond h annihilate by compact support) and the slot
    ADDRESSING over locals + ghosts on the skinned slab-local lattice, so
    the sort runs once a block.  Exchanged every step: the pinned ghosts'
    (x, v), then their (rho, p) between K1 and K2.  Deferred to the block
    end: migration and emitter activation (a particle that activates
    mid-block joins at the next block top).  The overflow folds in every
    audit: the ghost, migration and slot caps and the skin-drift count.

    The classic form scatters each step's particle state into the pinned
    slots and runs K1/K2 through the split API (K2 reads PyTorch's EOS p,
    as the per-step slab step).  slot_resident keeps the block IN the slot
    arrays (`_SlabSlots`): integration is elementwise there, K2 reads K1's
    rp with the ghosts' faces written in, and the locals are read back once
    at the block end.  On the CPU its x, rho and p are bitwise the classic
    form's and its v within the last bit: PyTorch's vectorized EOS rounds
    by an element's place in the vector, so the two layouts' p can differ
    by an ulp (ROADMAP.md Queue 3 item 10)."""
    params = scene.params
    if slot_resident and params.precision == "bf16":
        raise ValueError(
            "slot_resident decomp does not support precision='bf16': the "
            "slot-side cell-center frame is slab-local (shifted by k_dev "
            "cells), which would blow the bf16 relative-coordinate budget")
    dt = params.dt
    skin = step_mod.default_skin(scene, sort_every)
    h_eff = params.h + skin
    half2 = (0.5 * skin) ** 2
    leap = params.integrator == "leapfrog"
    bf16 = params.precision == "bf16"
    grid, sg, slab = _fast_grid(scene, spec, skin)
    nl, g_cap = spec.cap_local, spec.cap_ghost
    slots_on = _slab_slots(scene, spec, grid, sg, slab, skin, sort_every)

    def block(st: State):
        d = st.x.shape[1]
        active0 = st.active
        movable0 = active0 & (st.kind == 0)
        mov = movable0[:, None].to(st.x.dtype)
        x, v, acc = st.x, st.v, st.acc
        near_lo, near_hi = slab.bands(x, h_eff)
        idx_lo, val_lo, ov1 = _pack_idx(active0 & near_lo, g_cap)
        idx_hi, val_hi, ov2 = _pack_idx(active0 & near_hi, g_cap)
        faces = (idx_lo, val_lo, idx_hi, val_hi)
        overflow = ov1 + ov2

        if slot_resident:
            res = slots_on(st.x.device)
            if leap:
                v = v + (0.5 * dt) * acc * mov
                x = x + dt * v * mov
            c = res.build(x, v, active0, movable0,
                          _exchange_ghosts(slab, x, v, *faces), use_mem=False)
            # step 0's kick, drift and exchange ran above: the drift
            # audit's reference is the build's positions, and no acc is
            # scattered
            c.update(acc=None, pins=res.pins(c["addr"], *faces),
                     step0=st.step, drifted=True)
            overflow = overflow + c["addr"].overflow
            xs, vs, acc_s, rp, viol, _ = res.steps(c, use_mem=False)
            c.update(xs=xs, vs=vs, acc=acc_s, rp=rp)
            x, v, acc, rho, p = step_mod._read_back(
                res.sp, c, st.x, st.v, st.acc, st.rho, st.p, active0,
                movable0)
        else:
            x0_ref = x
            addr = None
            viol = torch.zeros((), dtype=torch.int32, device=x.device)
            for i in range(sort_every):
                if leap:
                    v = v + (0.5 * dt) * acc * mov
                    x = x + dt * v * mov
                gx, gv, g_valid = _exchange_ghosts(slab, x, v, *faces)
                cx = torch.cat([x, gx])
                cv = torch.cat([v, gv])
                if addr is None:
                    # block top: the pinned addressing, from the first
                    # exchange's positions (post-drift under leapfrog)
                    addr = pallas_step.build_addr(
                        cx, torch.cat([active0, g_valid]), grid, sg,
                        slab.ci_off)
                    overflow = overflow + addr.overflow
                rows = (pallas_step._rel_rows(cx, cv, addr) if bf16
                        else pallas_step._pack_rows6(cx, cv))
                ctx = pallas_step.SplitCtx(
                    sg=sg, addr=addr,
                    feat=pallas_step.scatter_slots(addr, rows, sg))
                rho = pallas_step.pallas_density_split(ctx, params)[:nl]
                p = physics.eos_pressure(rho, params)
                ghost_rho, ghost_p = _ghost_rho_p(slab, rho, p, idx_lo,
                                                  idx_hi, g_valid)
                f = pallas_step.pallas_forces_split(
                    ctx, torch.cat([rho, ghost_rho]), torch.cat([p, ghost_p]),
                    params, d)[:nl]
                x, v, acc = _integrate(scene, x, v, rho, f, st.step + i, mov,
                                       movable0)
                dd = x - x0_ref
                drift2 = torch.sum(dd * dd, dim=1)
                viol = viol + torch.sum((drift2 > half2) & active0,
                                        dtype=torch.int32)

        x, v, acc, kind, emit, ov_m = _migrate(slab, spec, x, v, acc, st.kind,
                                               st.emit_step, active0)
        return State(
            x=x, v=v, acc=acc,
            rho=torch.where(active0, rho, st.rho),
            p=torch.where(active0, p, st.p),
            kind=kind, emit_step=emit, step=st.step + sort_every,
        ), overflow + viol + ov_m

    return block


def _make_spatial_resident_auto(
    scene: Scene, spec: SpatialSpec, sort_every: int, blocks: int,
    rebuild_frac: float = 1.0, reactive_theta: float | None = None,
    membership_audit: bool = True, repair_k: int = 0,
):
    """AUTO-REBUILD slot residency on slabs, the decomposed form of
    `step._make_resident_auto_advance`: each rank's slot state persists
    ACROSS blocks, and the rebuild (read back → migrate → fresh face bands
    → addressing → scatter) runs only when the rebuild predicate, reduced
    over the ranks, fires somewhere on the mesh, or an emitter activated
    since the last build.

    Validity is the skin/2 contract of the classic fast path: while every
    particle has drifted < skin/2 from its BUILD position, the pinned
    addressing bins it correctly, the pinned h + skin band stays a superset
    of the exact h-band, and an unmigrated leaver is still in the
    neighbor's band, so migration can wait for the next rebuild.  The
    membership-relaxed audit adds two slab amendments: the ghost band
    doubles to 2·(h + skin) (a remote source within a local's cell window
    can sit up to h + cell past a face), and a slot beyond its face keeps
    the strict budget (the neighbor's band covers pairs around a leaver
    only to skin/2 past the face).

    HEAL: a block whose audit fires on any rank (drift, a cap at build, a
    ghost or migration buffer) is re-run exactly from its held block-top
    carry on the per-step slab step (`_make_spatial_local(..., "pallas")`),
    then residency is re-entered; a dispatch in which every block heals is
    bitwise the per-step slab advance.  REPAIR (repair_k > 0): the risky
    particles are re-homed in place, as on one device, only when every one
    of them is INTERIOR (outside both 2·(h + skin) bands at build, so no
    ghost copy of it exists and it cannot leave before the next rebuild);
    one rank's veto makes the whole mesh rebuild instead.

    The reference decides inside its scan with `lax.cond`s under predicates
    it reduces over the mesh; here the host takes each branch, every rank
    the same, on values all-reduced over the ranks and fetched once: at
    each block end one int tensor holds the block's audit count and the
    next block's `need` and activation flags (one fetch a block; after a
    heal one more for the fresh carry's `need`; a repair's plan one more,
    on the blocks that need a fix).  Collectives run only in the branches
    the host takes, the same on every rank: a block that keeps its
    residency sends no migration buffers.  Every branch builds fresh
    tensors from the held carry, so a heal re-runs from it untouched.

    Returns advance(loc) → (loc, worst, rebuilds, healed[, repairs]),
    device scalars the same on every rank; worst counts only what the heal
    could not repair (the per-step path's own caps, a spec too small) and
    the dispatch-end read-back and migration."""
    params = scene.params
    if params.precision == "bf16":
        raise ValueError(
            "auto-rebuild decomp does not support precision='bf16' (same "
            "slab-local cell-center frame limit as the resident block)")
    dt = params.dt
    d = params.dim
    skin = step_mod.default_skin(scene, sort_every)
    h_eff = params.h + skin
    budget = rebuild_frac * 0.5 * skin if rebuild_frac > 0 else 0.0
    leap = params.integrator == "leapfrog"
    use_mem = membership_audit
    band_w = 2.0 * h_eff if use_mem else h_eff
    if repair_k:
        if not use_mem:
            raise ValueError("repair_k requires membership_audit=True")
        if reactive_theta is not None or rebuild_frac <= 0:
            raise ValueError(
                "repair_k composes with the membership predicate only "
                "(reactive_theta=None, rebuild_frac > 0)")
    grid, sg, slab = _fast_grid(scene, spec, skin)
    g_cap = spec.cap_ghost
    per_step = _make_spatial_local(scene, spec, "pallas")
    slots_on = _slab_slots(scene, spec, grid, sg, slab, skin, sort_every)
    _fetch = step_mod._fetch
    if repair_k:
        # interior = outside both band selections at build (the anchors
        # are the selection positions): no rank holds a ghost copy of the
        # particle, so only such particles may be repaired
        plan_t, apply_t = step_mod.make_repair_tools(
            grid, sg, d, dt, sort_every, budget, repair_k,
            step_mod._SlotPhysics.gather, ci_off=slab.ci_off, faces=slab,
            band=band_w)

    def masks(sh, at_step):
        act = sh["emit"] <= at_step
        return act, act & (sh["kind"] == 0)

    def advance(loc: State):
        dev = loc.x.device
        res = slots_on(dev)
        store = slot_pass.SlotStore(sg, d, False, dev)
        i32 = dict(dtype=torch.int32, device=dev)

        def enter(sh, at_step) -> dict:
            """Shadow → fresh residency, from UNDRIFTED positions (the first
            block drifts in slot space).  Leapfrog: the block-top half-kick
            is applied in particle space to the scattered v; the shadow
            keeps the raw v, and until a block has run (`live`) the shadow
            is what a read-back returns.  The build's audits wait in
            `pend` for the next block's heal decision."""
            act0, movable0 = masks(sh, at_step)
            v = sh["v"]
            if leap:
                v = v + (0.5 * dt) * sh["acc"] * movable0[:, None].to(v.dtype)
            near_lo, near_hi = slab.bands(sh["x"], band_w)
            idx_lo, val_lo, ov1 = _pack_idx(act0 & near_lo, g_cap)
            idx_hi, val_hi, ov2 = _pack_idx(act0 & near_hi, g_cap)
            faces = (idx_lo, val_lo, idx_hi, val_hi)
            c = res.build(sh["x"], v, act0, movable0,
                          _exchange_ghosts(slab, sh["x"], v, *faces), use_mem)
            c.update(acc=torch.zeros_like(c["xs"]),
                     rp=c["xs"].new_zeros((sg.c_rows, 2, sg.lanes)),
                     pins=res.pins(c["addr"], *faces), shadow=sh,
                     build_step=at_step, step=at_step,
                     pend=c["addr"].overflow + ov1 + ov2, live=False)
            return c

        def materialize(c) -> dict:
            sh = c["shadow"]
            if not c["live"]:
                return dict(sh)
            act0, movable0 = masks(sh, c["build_step"])
            x, v, acc, rho, p = step_mod._read_back(
                res.sp, c, sh["x"], sh["v"], sh["acc"], sh["rho"], sh["p"],
                act0, movable0)
            return {**sh, "x": x, "v": v, "acc": acc, "rho": rho, "p": p}

        def exit_migrate(c):
            """Read back, then migrate the leavers of the last build's
            active set: (shadow, overflow)."""
            sh = materialize(c)
            act0, _ = masks(sh, c["build_step"])
            x, v, acc, kind, emit, ov_m = _migrate(
                slab, spec, sh["x"], sh["v"], sh["acc"], sh["kind"],
                sh["emit"], act0)
            return {**sh, "x": x, "v": v, "acc": acc, "kind": kind,
                    "emit": emit}, ov_m

        # the membership predicate is counted by the block's last slot_post
        fused_need = reactive_theta is None and use_mem and rebuild_frac > 0

        def need_flags(c, risky=None):
            """This rank's (need, activated) [2] i32 for the block that
            starts from `c`: the rebuild predicate or an activation since
            the last build, and the activation alone.  `risky`: the
            predicate's slots on `c`, counted by the block that ended in
            it."""
            emit = c["shadow"]["emit"]
            activated = torch.any((emit > c["build_step"])
                                  & (emit <= c["step"]))
            # an activation forces the rebuild: the new particles have no
            # slot until one
            if risky is not None:
                return torch.stack([(risky > 0) | activated,
                                    activated]).to(torch.int32)
            dd = c["xs"] - c["x0s"]
            dd2 = torch.sum(dd * dd, dim=1, keepdim=True)
            if reactive_theta is not None:
                # measured drift only; the heal backstops an overrun
                need = (torch.sqrt(torch.amax(dd2))
                        > reactive_theta * 0.5 * skin)
            elif fused_need:
                need = torch.any(slot_pass.membership_risky(
                    c, grid, dd2, dt, sort_every, budget,
                    ci_offset=slab.ci_off,
                    extra_margin=slot_pass.face_margin(slab, c["xs"])))
            else:
                drift_now = torch.sqrt(torch.amax(dd2))
                vmax = torch.sqrt(torch.amax(torch.sum(c["vs"] * c["vs"],
                                                       dim=1)))
                need = drift_now + 1.2 * vmax * dt * sort_every > budget
            return torch.stack([need | activated, activated]).to(torch.int32)

        def mesh_need(c):
            need, act = _fetch(*comm.all_reduce_sum(need_flags(c)))
            return need > 0, act > 0

        if repair_k:
            def plan_repair(c):
                sh = c["shadow"]
                act0, movable0 = masks(sh, c["build_step"])
                return plan_t(c, sh["x"], act0, movable0)

            def apply_repair(c, plan):
                # advance the repaired particles' plan anchors, or they
                # stay phantom-risky against their old cells
                sh = c["shadow"]
                c2 = apply_t(c, plan, store.filled(c), anchors=sh["x"])
                store.readdress(c["addr"], c2["addr"])
                x = c2.pop("anchors")
                return {**c2, "shadow": {**sh, "x": x}}

        sh0 = dict(x=loc.x, v=loc.v, acc=loc.acc, rho=loc.rho, p=loc.p,
                   kind=loc.kind, emit=loc.emit_step)
        c = enter(sh0, loc.step)
        over = torch.zeros((), **i32)
        rebuilds, healed, repairs = 1, 0, 0
        need, act_any = mesh_need(c)
        for b in range(blocks):
            step_mod.FETCHES["blocks"] += 1
            step0 = c["step"]
            do_rep = False
            if need and repair_k and not act_any:
                # every rank plans its local repair; the mesh repairs
                # together iff no rank vetoes (a rank with nothing risky
                # consents), else it rebuilds together
                plan = plan_repair(c)
                veto = ~(plan["can"] | (plan["n_risky"] == 0))
                (n_veto,) = _fetch(comm.all_reduce_sum(veto.to(torch.int32)))
                if n_veto == 0:
                    c = apply_repair(c, plan)
                    do_rep, need = True, False
            if need:
                # rebuild: read back + migrate, drift in particle space,
                # fresh bands, exchange, build
                shA, ov_a = exit_migrate(c)
                shB = shA
                act0, movable0 = masks(shA, step0)
                if leap:
                    mv = movable0[:, None].to(shA["v"].dtype)
                    v = shA["v"] + (0.5 * dt) * shA["acc"] * mv
                    shB = {**shA, "v": v, "x": shA["x"] + dt * v * mv}
                near_lo, near_hi = slab.bands(shB["x"], band_w)
                idx_lo, val_lo, ov1 = _pack_idx(act0 & near_lo, g_cap)
                idx_hi, val_hi, ov2 = _pack_idx(act0 & near_hi, g_cap)
                faces = (idx_lo, val_lo, idx_hi, val_hi)
                sl = res.build(shB["x"], shB["v"], act0, movable0,
                               _exchange_ghosts(slab, shB["x"], shB["v"],
                                                *faces), use_mem)
                sl.update(acc=torch.zeros_like(sl["xs"]),
                          pins=res.pins(sl["addr"], *faces),
                          build_step=step0, drifted=True)
                audit = ov_a + ov1 + ov2 + sl["addr"].overflow
            else:
                # keep: step 0's kick, drift and exchange in the slots
                shB = c["shadow"]
                sl = {k: c[k] for k in ("addr", "movb", "refs", "jb", "acc",
                                        "x0s", "pins", "build_step", "xs",
                                        "vs", "feat")}
                sl["drifted"] = False
                audit = torch.zeros((), **i32)
            sl["step0"] = step0
            xs, vs, acc_s, rp, viol, risky = res.steps(
                sl, use_mem, budget if fused_need else None, store)
            blk_audit = c["pend"] + audit + viol
            ok_carry = {**sl, "xs": xs, "vs": vs, "acc": acc_s, "rp": rp,
                        "shadow": shB, "step": step0 + sort_every,
                        "pend": torch.zeros((), **i32), "live": True}
            more = b + 1 < blocks
            flags = [blk_audit.reshape(1)]
            if more:
                flags.append(need_flags(ok_carry, risky))
            vals = _fetch(*comm.all_reduce_sum(torch.cat(flags)))
            if vals[0] > 0:
                # heal: re-run this block exactly on the per-step slab step
                # from its held block-top carry, then re-enter residency
                sm = materialize(c)
                st1 = State(x=sm["x"], v=sm["v"], acc=sm["acc"],
                            rho=sm["rho"], p=sm["p"], kind=sm["kind"],
                            emit_step=sm["emit"], step=step0)
                for _ in range(sort_every):
                    st1, ov_s = per_step(st1)
                    over = over + ov_s
                c = enter(dict(x=st1.x, v=st1.v, acc=st1.acc, rho=st1.rho,
                               p=st1.p, kind=st1.kind, emit=st1.emit_step),
                          st1.step)
                healed += 1
                rebuilds += 1
                if more:
                    need, act_any = mesh_need(c)
            else:
                c = ok_carry
                over = over + blk_audit
                rebuilds += int(need)
                if more:
                    need, act_any = vals[1] > 0, vals[2] > 0
            repairs += int(do_rep)

        # dispatch end: read back, final migration
        sh, ov_m = exit_migrate(c)
        worst = comm.all_reduce_sum(over + c["pend"] + ov_m)
        out = State(x=sh["x"], v=sh["v"], acc=sh["acc"], rho=sh["rho"],
                    p=sh["p"], kind=sh["kind"], emit_step=sh["emit"],
                    step=c["step"])
        counts = (rebuilds, healed) + ((repairs,) if repair_k else ())
        return (out, worst) + tuple(torch.tensor(n, **i32) for n in counts)

    return advance


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
    rebuild_frac: float = 1.0,
    reactive_theta: float | None = None,
    membership_audit: bool = True,
    repair_k: int = 0,
):
    """`steps_per_dispatch` slab steps: loc → (loc, worst) where worst is
    the largest over the steps (or blocks) of the overflow summed over
    ranks ([] i32 on the device, the same on every rank; > 0 means a ghost,
    migration, local or slot cap dropped particles, or on the fast path the
    skin-drift audit fired, and the dispatch's physics is not to be
    trusted).  The per-step counts are summed over ranks in one all-reduce
    at the end of the dispatch.

    sort_every > 1 (pallas): the slab fast path, `sort_every`-step blocks
    with pinned ghost selections and addressing and migration at the block
    ends (`_make_spatial_reuse_local`); slot_resident keeps each block in
    the slot arrays.  auto_rebuild (slot_resident) keeps the residency
    across blocks, rebuilding and migrating only when the mesh-wide
    predicate asks, and heals a violating block in-dispatch on the
    per-step slab step (`_make_spatial_resident_auto`); it returns (loc,
    worst, rebuilds, healed) instead, plus a trailing `repairs` when
    repair_k > 0, and worst then counts only what healing could not
    repair."""
    if slot_resident and sort_every <= 1:
        raise ValueError("slot_resident requires sort_every > 1")
    if auto_rebuild and not slot_resident:
        raise ValueError("auto_rebuild requires slot_resident=True")
    if sort_every > 1:
        if method != "pallas":
            raise ValueError(
                ("auto_rebuild" if auto_rebuild else "sort_every > 1")
                + " requires method='pallas'")
        if steps_per_dispatch % sort_every:
            raise ValueError(
                f"steps_per_dispatch={steps_per_dispatch} must be a "
                f"multiple of sort_every={sort_every}")
    if auto_rebuild:
        return _make_spatial_resident_auto(
            scene, spec, sort_every, steps_per_dispatch // sort_every,
            rebuild_frac=rebuild_frac, reactive_theta=reactive_theta,
            membership_audit=membership_audit, repair_k=repair_k)
    if sort_every > 1:
        body = _make_spatial_reuse_local(scene, spec, sort_every,
                                         slot_resident=slot_resident)
        return _dispatch(body, steps_per_dispatch // sort_every)
    return _dispatch(_make_spatial_local(scene, spec, method),
                     steps_per_dispatch)


def _dispatch(body, length: int):
    """advance(loc) → (loc, worst): `length` calls of the per-rank `body`,
    worst the largest over them of the overflow summed over ranks (one
    all-reduce of the stacked counts at the end)."""

    def advance(loc: State):
        overs = []
        for _ in range(length):
            loc, over = body(loc)
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
    reactive_theta: float | None = None,
    membership_audit: bool = True,
    repair_k: int | None = None,
):
    """`advance(loc) -> loc` with the single-device audited policy across
    the ranks: when the fast path's skin/cap audit fires, the dispatch is
    re-run from its held input on the per-step slab path, fast when the
    skin bound holds and exact when not; when even the per-step path
    overflows a static buffer it raises SpatialCapOverflow (the spec must
    be resized).  Every decision is taken on values all-reduced over the
    ranks, so every rank takes it together (one rank raising alone would
    leave the others waiting in a collective).

    auto_rebuild (the default; the slot-resident fast path only): the
    auto-rebuild residency with its in-dispatch heal and, with repair_k
    None, `step.default_repair_k`'s minority repair.  CONSTANT-HEAL
    DEMOTION: once every block of `step.DEMOTE_PATIENCE` consecutive
    dispatches heals, the advance runs the per-step slab path and
    re-probes the fast path every `step.PERSTEP_REPROBE_EVERY` dispatches
    (both read at call time).  Carries the reference's observability
    attributes (`healed`, `repaired`, `mode`) and the port's `rebuilds`;
    one fetch a dispatch reads the counters."""
    auto = auto_rebuild and slot_resident and sort_every > 1
    if repair_k is None:
        # the single-device default; the slab repair is interior-only and
        # veto-guarded, and repair_k=0 pins rebuild-only
        repair_k = step_mod.default_repair_k(
            scene, auto=auto, membership_audit=membership_audit,
            reactive_theta=reactive_theta)
    adv = make_spatial_advance(
        scene, spec, method, steps_per_dispatch, sort_every=sort_every,
        slot_resident=slot_resident, auto_rebuild=auto,
        reactive_theta=reactive_theta if auto else None,
        membership_audit=membership_audit,
        repair_k=repair_k if auto else 0)
    exact = []      # the per-step slab advance, made at first use
    blocks = max(steps_per_dispatch // max(sort_every, 1), 1)
    streak = [0]    # consecutive all-blocks-healed fast dispatches
    demoted = [0]   # dispatches run since demotion (0 = fast path)

    def _note(msg: str) -> None:
        print(f"sph_tpu_torch: {msg}", file=sys.stderr)

    def _raise_overflow(at: int, worst: int):
        raise SpatialCapOverflow(
            f"spatial dispatch at step {at} overflowed a static buffer even "
            f"on the per-step path (worst={worst}); rebuild the SpatialSpec "
            f"from the current state (SpatialSpec.for_state)")

    def _exact_run(loc: State) -> State:
        if not exact:
            exact.append(make_spatial_advance(scene, spec, method,
                                              steps_per_dispatch))
        out, worst = exact[0](loc)
        worst, at = step_mod._fetch(worst, loc.step)
        if worst:
            _raise_overflow(at, worst)
        return out

    def _dispatch_fast(loc: State):
        """One fast dispatch → (state, healed blocks); its counters and the
        step in one fetch."""
        res = adv(loc)
        out = res[0]
        vals = step_mod._fetch(*res[1:], loc.step)
        worst, at = vals[0], vals[-1]
        healed = vals[2] if len(vals) > 3 else 0
        if len(vals) > 3:
            audited.rebuilds += vals[1]
        if len(vals) > 4:
            audited.repaired += vals[3]
        if healed:
            audited.healed += healed
            _note(f"skin/cap violations at step {at} — {healed} block(s) "
                  f"re-ran exactly on the per-step spatial path "
                  f"(in-dispatch, mesh-uniform)")
        if worst == 0:
            return out, healed
        if sort_every > 1:
            _note(f"{worst} skin/cap violations in a spatial "
                  f"{steps_per_dispatch}-step dispatch at step {at} — "
                  f"re-ran exactly (per-step rebuild)")
            # the whole dispatch re-ran per step: all blocks count as
            # healed for the demotion streak
            return _exact_run(loc), blocks
        _raise_overflow(at, worst)

    def audited(loc: State) -> State:
        if demoted[0]:
            demoted[0] += 1
            if demoted[0] % step_mod.PERSTEP_REPROBE_EVERY:
                return _exact_run(loc)
            out, healed = _dispatch_fast(loc)
            if healed >= blocks:
                return out      # still violent: stay demoted
            demoted[0] = 0
            streak[0] = 0
            audited.mode = "resident"
            _note(f"drift back under the Verlet budget at step "
                  f"{step_mod._fetch(loc.step)[0]} ({healed}/{blocks} "
                  f"blocks healed) — resuming the resident spatial fast path")
            return out
        out, healed = _dispatch_fast(loc)
        streak[0] = streak[0] + 1 if healed >= blocks else 0
        if streak[0] >= step_mod.DEMOTE_PATIENCE:
            demoted[0] = 1
            audited.mode = "perstep"
            _note(f"flow outruns the Verlet drift budget — every block "
                  f"healed {streak[0]} dispatches straight at step "
                  f"{step_mod._fetch(loc.step)[0]}; demoting to the "
                  f"per-step spatial path (re-probes every "
                  f"{step_mod.PERSTEP_REPROBE_EVERY} dispatches)")
        return out

    audited.healed = 0      # cumulative in-dispatch healed blocks
    audited.repaired = 0    # cumulative minority-repaired blocks
    audited.rebuilds = 0    # cumulative residency builds (the port's own)
    audited.mode = "resident"
    return audited


# ---------------------------------------------------------------------------
# 4. Pencils: two cut axes on a 2-D rank grid, corner ghosts by two hops
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PencilSpec:
    """Static 2-axis decomposition geometry: the domain cut into n1 × n2
    rectangular pencils along (axis1, axis2), rank i1·n2 + i2 holding
    pencil (i1, i2) (the reference's fields, one for one).  Pencils keep
    each cut direction coarse where slabs would fall below 2h."""

    n1: int
    n2: int
    axis1: int
    axis2: int
    lo1: float
    lo2: float
    w1: float
    w2: float
    cap_local: int
    cap_ghost: int   # per face, both axes: phase-2 bands hold phase-1
    #                  ghosts, so it is sized from the worst band of either
    cap_mig: int

    @staticmethod
    def for_state(scene: Scene, state, n1: int, n2: int, axis1: int = 0,
                  axis2: int | None = None, headroom: float = 3.0,
                  skin: float = 0.0) -> "PencilSpec":
        """`SpatialSpec.for_state`'s sizing: cap_local from the worst
        pencil, cap_ghost from the worst 2·(h + skin)-deep face band of
        either axis.  axis2 defaults to the last axis (3D: z, so a dam's
        vertical axis y stays uncut)."""
        if axis2 is None:
            axis2 = scene.params.dim - 1
        if axis1 == axis2:
            raise ValueError("pencil axes must differ")
        lo1, hi1 = scene.lo[axis1], scene.hi[axis1]
        lo2, hi2 = scene.lo[axis2], scene.hi[axis2]
        w1 = (hi1 - lo1) / n1
        w2 = (hi2 - lo2) / n2
        if min(w1, w2) < 2 * scene.params.h:
            raise ValueError(
                f"pencil widths ({w1:.1f}, {w2:.1f}) < 2h; fewer shards")
        x = _host(state.x)
        live = _host(state.emit_step) != int(INACTIVE)
        owner = _pencil_of(x, axis1, lo1, w1, n1, axis2, lo2, w2, n2)
        worst = int(np.bincount(owner[live], minlength=n1 * n2).max())
        cap_local = min(
            _round_up(x.shape[0], 64),
            _round_up(int(worst * headroom) + 64, 64),
        )
        h_eff = scene.params.h + skin
        band = 0
        for n, lo, w, ax in ((n1, lo1, w1, axis1), (n2, lo2, w2, axis2)):
            xa = x[live, ax]
            for i in range(1, n):
                band = max(band, int(np.sum(np.abs(xa - (lo + i * w))
                                            < 2.0 * h_eff)))
        cap_ghost = min(
            _round_up(cap_local // 2 + 64, 64),
            _round_up(int(band * headroom) + 256, 64),
        )
        return PencilSpec(
            n1=n1, n2=n2, axis1=axis1, axis2=axis2, lo1=lo1, lo2=lo2,
            w1=w1, w2=w2, cap_local=cap_local, cap_ghost=cap_ghost,
            cap_mig=max(_round_up(cap_ghost // 2, 64), 256),
        )


def _pencil_of(x, axis1, lo1, w1, n1, axis2, lo2, w2, n2) -> np.ndarray:
    """The pencil (rank i1·n2 + i2) of each position."""
    return _part(x[:, axis1], lo1, w1, n1) * n2 + _part(x[:, axis2], lo2,
                                                        w2, n2)


def pencil_parts(state, spec: PencilSpec) -> list[dict]:
    """`spatial_slabs` for pencils: the per-pencil arrays in rank order
    (row-major (i1, i2))."""
    return _split(state, lambda x: _pencil_of(x, spec.axis1, spec.lo1,
                                              spec.w1, spec.n1, spec.axis2,
                                              spec.lo2, spec.w2, spec.n2),
                  spec.n1 * spec.n2, spec.cap_local, "pencil")


def pencil_shard_state(state, scene: Scene, spec: PencilSpec,
                       device=None) -> State:
    """This rank's pencil of a global `state` (the same on every rank) as a
    local State on its device."""
    if comm.world_size() != spec.n1 * spec.n2:
        raise ValueError(
            f"the spec has {spec.n1}x{spec.n2} pencils, the process group "
            f"{comm.world_size()} ranks")
    return _local_state(pencil_parts(state, spec)[comm.rank()], state.step,
                        comm.rank_device(device))


def _pencil_faces(scene: Scene, spec: PencilSpec, grid) -> tuple:
    """This rank's pencil: one `_Slab` a cut axis (axis 1, then axis 2),
    each with its ring along that axis of the rank grid, and the lattice's
    ci_offset on both cut axes (None without a lattice)."""
    ranks = comm.RankGrid(spec.n1, spec.n2)
    ci_off = [0] * scene.params.dim
    faces = []
    for k, (ax, lo, w, n, i) in enumerate(zip(
            (spec.axis1, spec.axis2), (spec.lo1, spec.lo2),
            (spec.w1, spec.w2), (spec.n1, spec.n2), ranks.coords())):
        my_lo, my_hi, k_dev = _faces(scene, grid, ax, lo, w, i)
        ci_off[ax] = k_dev
        faces.append(_Slab(axis=ax, first=i == 0, last=i == n - 1,
                           lo=float(my_lo), hi=float(my_hi), ci_off=None,
                           peers=ranks.peers(k)))
    return tuple(faces), (tuple(ci_off) if grid is not None else None)


def _make_pencil_local(scene: Scene, spec: PencilSpec,
                       method: str = "pallas"):
    """The per-rank pencil step: st → (st, local overflow count [] i32),
    on the pencil-local lattice (`GridSpec.for_pencil`)."""
    grid = None
    if method in ("grid", "pallas"):
        grid = neighbors.GridSpec.for_pencil(
            scene, {spec.axis1: spec.w1, spec.axis2: spec.w2})
    faces, ci_off = _pencil_faces(scene, spec, grid)
    return _make_local(scene, spec, faces, ci_off, grid, method)


def make_pencil_step(scene: Scene, spec: PencilSpec, method: str = "pallas"):
    """One pencil step: loc → (loc, overflow summed over ranks [] i32)."""
    local = _make_pencil_local(scene, spec, method)

    def step(loc: State):
        out, over = local(loc)
        return out, comm.all_reduce_sum(over)

    return step


def make_pencil_advance(scene: Scene, spec: PencilSpec,
                        method: str = "pallas", steps_per_dispatch: int = 50):
    """`steps_per_dispatch` pencil steps: loc → (loc, worst), the audit
    contract of `make_spatial_advance`."""
    return _dispatch(_make_pencil_local(scene, spec, method),
                     steps_per_dispatch)


def make_audited_pencil_advance(scene: Scene, spec: PencilSpec,
                                method: str = "pallas",
                                steps_per_dispatch: int = 100):
    """`advance(loc) -> loc` over pencils, the contract of
    `make_audited_spatial_advance`.  Pencils step per step only, so a
    nonzero audit has no faster path to fall back from: it is a static
    buffer outgrown, raised as SpatialCapOverflow on every rank together
    (worst is summed over the ranks) for the caller's re-spec."""
    adv = make_pencil_advance(scene, spec, method, steps_per_dispatch)

    def audited(loc: State) -> State:
        out, worst = adv(loc)
        worst, at = step_mod._fetch(worst, loc.step)
        if worst == 0:
            return out
        raise SpatialCapOverflow(
            f"pencil dispatch at step {at} overflowed a static buffer "
            f"(worst={worst}); rebuild the PencilSpec from the current "
            f"state (PencilSpec.for_state)")

    return audited
