"""Minority slot repair of the resident auto-rebuild advance: its plan (which
particles are about to leave their build cells, and the free slots of the
cells they go to) and its apply (re-homing them inside the addressing),
wrappers around the CUDA kernels in `csrc/repair_kernels.cu`, their plain
PyTorch versions, and their launch counts.

`make_repair_tools` gives the (plan, apply) pair the advances call, on the
single-device lattice and on a slab's (`decomp.py`: its index offset, its
faces and bands).  A call on CUDA tensors launches the kernels: three for
the plan, two for the apply.  A call on CPU tensors runs the plain
versions, `make_repair_tools_plain`: the PyTorch sequence the advance ran
before the kernels, op for op, which the tests also hold the kernels to.
The kernels give the plain versions' bits (`can`, `n_risky`,
`pids` and `vm` everywhere, the movers' `x_m`, old and new slot; every
array the apply writes), so a run's trajectory and counters do not depend
on which ran.  `LAUNCHES` counts kernel launches only (none while a CUDA
graph is captured).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from sph_tpu_torch import _build, neighbors
from sph_tpu_torch.platform import device_const
from sph_tpu_torch.slot_kernels import LANE, _f32, _raise_on, _stream
from sph_tpu_torch.slot_pass import _check, _sm_count

#: kernel launches per kernel since the last `reset_launches()`
LAUNCHES = {"repair_particles": 0, "repair_movers": 0, "repair_lanes": 0,
            "repair_copy": 0, "repair_patch": 0}

#: the most slot storages an apply patches besides the carry's
MAX_ALSO = 2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def make_repair_tools_plain(grid, sg, d, dt, sort_every, budget, repair_k,
                            gather, ci_off=None):
    """(plan_plain, apply_plain) for MINORITY SLOT REPAIR (see
    `step._make_resident_auto_advance`).  Planned in particle space: `x0_p`
    holds every particle's build anchor (the shadow's x, which the caller
    advances for repaired particles), `c["addr"]` its slot (its first
    `len(x0_p)` entries: a slab's addressing also holds its ghosts).  The
    risky test is the particle-space mirror of `slot_pass.membership_risky`,
    1.2× projection included.  `ci_off` is a slab-local lattice's index
    shift; `face_fn(x_now) -> (face_margin, allowed)` lets a slab fold its
    face distance into the margin and veto the repair of any particle
    outside `allowed` (a band particle has ghost copies on a neighbor whose
    addressing a local repair cannot patch).

    The free-lane search works on the movers' target cells only: their
    `[repair_k, cap]` occupancy rows, never the whole slot storage.

    JAX's padded `nonzero(size=)` becomes a cumsum rank scattered into a
    buffer with one spare dump entry, and its dropped `.at[].set/add` writes
    go to one spare element past the end of each array, sliced off after."""
    n_codes = sg.h0 * sg.h1
    usable_rows = sg.c_rows - 1
    big = 2**30
    i32, i64 = torch.int32, torch.int64

    def plan_plain(c, x0_p, act0, movable0, face_fn=None):
        addr = c["addr"]
        dev = x0_p.device
        cap_n = x0_p.shape[0]
        ok = addr.ok()[:cap_n]
        x_now = gather(c["xs"], d, addr)[:cap_n]
        v_now = gather(c["vs"], d, addr)[:cap_n]
        speed_p = torch.sqrt(torch.sum(v_now * v_now, dim=1))
        move_p = (1.2 * dt * sort_every) * speed_p
        dd = x_now - x0_p
        drift_p = torch.sqrt(torch.sum(dd * dd, dim=1))
        ci0, _ = neighbors.cell_index(x0_p, act0, grid, ci_off)
        if ci_off is not None:
            ci0 = ci0 + device_const(tuple(ci_off), i32, dev)  # global bins
        lo = device_const(grid.lo, x0_p.dtype, dev)
        lo_c = lo[None, :] + ci0.to(x0_p.dtype) * grid.cell
        margin_p = torch.amin(
            torch.minimum(x_now - lo_c, lo_c + grid.cell - x_now), dim=1)
        allowed = None
        if face_fn is not None:
            face_m, allowed = face_fn(x_now)
            margin_p = torch.minimum(margin_p, face_m)
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
        ci_m, _ = neighbors.cell_index(x_m, vm, grid, ci_off)
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
        # free lane.  Only the movers' K target cells are scanned, as
        # [K, cap] rows gathered from the occupancy: a cell's count of
        # free lanes depends on its own row alone
        size = sg.c_rows * sg.lanes
        occ = torch.cat([(c["xs"][:, 0, :] < 1e17).reshape(-1),
                         torch.zeros(1, dtype=torch.bool, device=dev)])
        occ.index_put_(
            (torch.where(vm, old_row.long() * sg.lanes + old_pos.long(),
                         size),),
            torch.zeros((), dtype=torch.bool, device=dev))
        occ3 = occ[:size].reshape(sg.c_rows * sg.h2, sg.cap)
        cellkey = new_row * sg.h2 + hx_m
        key = torch.where(vm, cellkey, big)
        order = torch.argsort(key, stable=True)
        ksort = key[order]
        first = torch.searchsorted(ksort, ksort)
        rank = torch.empty(repair_k, dtype=i64, device=dev).scatter_(
            0, order, torch.arange(repair_k, device=dev) - first)
        rowsel = torch.clamp(cellkey, 0, sg.c_rows * sg.h2 - 1).long()
        occ_row = occ3[rowsel]                                  # [K, cap]
        cf_row = torch.cumsum((~occ_row).to(i32), dim=1)
        onehot = (~occ_row) & (cf_row == (rank + 1)[:, None])
        placeable = torch.any(onehot, dim=1)
        lane_in = torch.argmax(onehot.to(i32), dim=1).to(i32)
        new_pos = hx_m * sg.cap + lane_in

        can = ((n_risky <= repair_k) & (n_risky > 0)
               & ~torch.any(vm & ((new_row == 0) | ~placeable)))
        if allowed is not None:
            can = can & ~torch.any(risky & ~allowed)
        return dict(can=can, n_risky=n_risky, pids=pids, vm=vm, x_m=x_m,
                    old_row=old_row, old_pos=old_pos,
                    new_row=new_row, new_pos=new_pos)

    def apply_plain(c, plan_d, also=(), anchors=None):
        """Patch the carry's six slot arrays IN PLACE and return it with
        the new addr (pure re-addressing: the particle state this carry
        materializes is bitwise unchanged), and the x, v and acc of each
        `slot_pass.SlotBlock` in `also` at the same slots with the same
        values (the other storage filled for this addressing, see
        `slot_pass.SlotStore`).  Does not touch the caller's shadow: with
        `anchors` (the shadow's x, the plan's `x0_p`) the returned carry
        also holds, under "anchors", a copy advanced to x_m at the repaired
        pids, which the caller makes its shadow's x, or they stay
        phantom-risky against their old anchors."""
        addr = c["addr"]
        dev = addr.pos.device
        vm = plan_d["vm"]
        zero_i = torch.zeros_like(plan_d["old_row"]).long()
        old_row, old_pos, new_row, new_pos = (
            torch.where(vm, plan_d[k].long(), zero_i)
            for k in ("old_row", "old_pos", "new_row", "new_pos"))

        def take(arr):
            """[ncols, K] values of the movers' old slots."""
            return arr[old_row, :, old_pos].T

        def put(arr, row, pos, vals):
            """arr[row, :, pos] = vals [ncols, K] for the movers, in place;
            the others write the dummy slot (row 0, lane 0) its own
            value."""
            ncols = arr.shape[1]
            keep = torch.where(vm[None, :], vals, arr[0, :, 0][:, None])
            cols = torch.arange(ncols, device=dev)[:, None]
            arr.index_put_((row[None, :], cols, pos[None, :]), keep)

        def move(arr, new_vals, old_vals):
            """Per-axis slot move: sentinel the old slots FIRST so a
            same-cell re-home landing on its own lane keeps the value."""
            put(arr, old_row, old_pos, old_vals)
            put(arr, new_row, new_pos, new_vals)

        x_cols = plan_d["x_m"].T
        far = torch.full_like(x_cols, 1e18)
        zero = torch.zeros_like(x_cols)
        rp_cols = take(c["rp"])
        v_cols, a_cols = take(c["vs"]), take(c["acc"])
        for xs, vs, acc in [(c["xs"], c["vs"], c["acc"])] + [
                (h.xs, h.vs, h.acc) for h in also]:
            move(xs, x_cols, far)
            move(vs, v_cols, zero)
            move(acc, a_cols, zero)
        move(c["x0s"], x_cols, far)
        move(c["rp"], rp_cols, torch.zeros_like(rp_cols))
        move(c["movb"], torch.ones_like(vm)[None, :],
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
            pos=patch(addr.pos, plan_d["new_pos"]),
            row_pos=patch(addr.row_pos, plan_d["new_row"]),
            gcounts=gfl[:n_g].reshape(addr.gcounts.shape),
        )
        out = {**c, "addr": addr2}
        if anchors is not None:
            n_a = anchors.shape[0]
            aidx = torch.where(vm, plan_d["pids"], n_a)
            x_ext = torch.cat([anchors, anchors.new_zeros((1, d))])
            x_ext.index_put_((aidx,), plan_d["x_m"])
            out["anchors"] = x_ext[:n_a]
        return out

    return plan_plain, apply_plain


def slab_face_fn(faces, band: float, x0_p):
    """`plan_plain`'s `face_fn` of a slab (`decomp._Slab`): the distance to
    its nearer interior face, and as `allowed` the particles whose anchors
    `x0_p` lie in neither band of depth `band` (no neighbor holds a ghost
    copy of them)."""
    near_lo, near_hi = faces.bands(x0_p, band)
    interior = ~(near_lo | near_hi)
    return lambda x_now: (faces.face_margin(x_now[:, faces.axis]), interior)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


class _RepairConsts(ctypes.Structure):
    """The CUDA source's `RepairConsts`, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "cap", "xc", "h1", "h2", "n_codes", "lanes", "c_rows",
            "n_groups")]
        + [("shape", ctypes.c_int * 3), ("off", ctypes.c_int * 3)]
        + [(n, ctypes.c_int) for n in (
            "face_axis", "face_lo_on", "face_hi_on")]
        + [("lo", ctypes.c_float * 3)]
        + [(n, ctypes.c_float) for n in (
            "cell", "move_k", "budget", "face_lo", "face_hi", "band_lo",
            "band_hi")]
    )


def _consts(grid, sg, dt, sort_every, budget, ci_off, faces,
            band) -> _RepairConsts:
    k = _RepairConsts()
    k.cap, k.xc, k.h1, k.h2 = sg.cap, sg.xc, sg.h1, sg.h2
    k.n_codes, k.lanes, k.c_rows = sg.h0 * sg.h1, sg.lanes, sg.c_rows
    k.n_groups = sg.n_groups
    for a in range(grid.dim):
        k.shape[a] = grid.shape[a]
        k.off[a] = 0 if ci_off is None else ci_off[a]
        k.lo[a] = _f32(grid.lo[a])
    k.cell = _f32(grid.cell)
    k.move_k = _f32(1.2 * dt * sort_every)
    k.budget = _f32(budget)
    k.face_axis = -1
    if faces is not None:
        # the faces and bands as `_Slab.face_margin` and `.bands` take them
        f32 = np.float32
        k.face_axis = faces.axis
        k.face_lo_on, k.face_hi_on = not faces.first, not faces.last
        k.face_lo, k.face_hi = _f32(faces.lo), _f32(faces.hi)
        k.band_lo = float(f32(faces.lo) + f32(band))
        k.band_hi = float(f32(faces.hi) - f32(band))
    return k


def _count(name: str) -> None:
    if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing
        LAUNCHES[name] += 1


def _check_plan(c, x0_p, act0, movable0, sg, d) -> tuple:
    """Raise on a carry or particle arrays the plan kernels do not take; →
    the row strides of xs and vs."""
    addr = c["addr"]
    dev = x0_p.device
    shape = (sg.c_rows, d, sg.lanes)
    rs = tuple(_check(k, c[k], torch.float32, dev, shape, sg.lanes)
               for k in ("xs", "vs"))
    n = addr.pos.shape[0]
    cap_n = x0_p.shape[0]
    if not 0 < cap_n <= n:
        raise ValueError(f"x0_p holds {cap_n} particles, the addressing {n}")
    _check("x0_p", x0_p, torch.float32, dev, (cap_n, d))
    for name, t in (("act0", act0), ("movable0", movable0)):
        _check(name, t, torch.bool, dev, (cap_n,))
    _check("valid", addr.valid, torch.bool, dev, (n,))
    for name in ("pos", "row_pos"):
        _check(name, getattr(addr, name), torch.int32, dev, (n,))
    _check("row_code", addr.row_code, torch.int32, dev, (sg.c_rows,))
    _check("n_occ", addr.n_occ, torch.int32, dev, (1,))
    return rs


def _check_apply(c, plan_d, also, anchors, sg, d, repair_k) -> dict:
    """Raise on a carry, plan, storages or anchors the apply kernels do not
    take; → the row strides of the slot arrays by name."""
    addr = c["addr"]
    dev = addr.pos.device
    lanes = sg.lanes
    shape = (sg.c_rows, d, lanes)
    if len(also) > MAX_ALSO:
        raise ValueError(f"an apply patches at most {MAX_ALSO} storages "
                         f"besides the carry's, got {len(also)}")
    rs = {k: _check(k, c[k], torch.float32, dev, shape, lanes)
          for k in ("xs", "vs", "acc", "x0s")}
    rs["rp"] = _check("rp", c["rp"], torch.float32, dev,
                      (sg.c_rows, 2, lanes), lanes)
    rs["movb"] = _check("movb", c["movb"], torch.bool, dev,
                        (sg.c_rows, 1, lanes), lanes)
    for i, h in enumerate(also):
        for k in ("xs", "vs", "acc"):
            rs[f"{k}{i}"] = _check(f"also[{i}].{k}", getattr(h, k),
                                   torch.float32, dev, shape, lanes)
    k_shape = (repair_k,)
    _check("vm", plan_d["vm"], torch.bool, dev, k_shape)
    _check("pids", plan_d["pids"], torch.int64, dev, k_shape)
    _check("x_m", plan_d["x_m"], torch.float32, dev, (repair_k, d))
    for name in ("old_row", "old_pos", "new_row", "new_pos"):
        _check(name, plan_d[name], torch.int32, dev, k_shape)
    n = addr.pos.shape[0]
    for name in ("pos", "row_pos"):
        _check(name, getattr(addr, name), torch.int32, dev, (n,))
    _check("gcounts", addr.gcounts, torch.int32, dev,
           (sg.c_rows, 1, sg.n_groups))
    if anchors is not None:
        _check("anchors", anchors, torch.float32, dev, (anchors.shape[0], d))
    return rs


def make_repair_tools(grid, sg, d, dt, sort_every, budget, repair_k, gather,
                      ci_off=None, faces=None, band=0.0):
    """(plan, apply) for MINORITY SLOT REPAIR, as `make_repair_tools_plain`
    takes and returns them: the kernels for CUDA tensors, the plain
    versions for CPU tensors.  A slab passes its lattice's `ci_off`, its
    `faces` (`decomp._Slab`) and the depth `band` of its ghost bands: the
    plan folds the face distance into the margin, and a risky particle
    whose anchor lies in a band vetoes the repair (`slab_face_fn`).
    `gather` is `_SlotPhysics.gather`, which the kernels compute
    themselves."""
    plan_plain, apply_plain = make_repair_tools_plain(
        grid, sg, d, dt, sort_every, budget, repair_k, gather, ci_off)
    consts = _consts(grid, sg, dt, sort_every, budget, ci_off, faces, band)

    def plan(c, x0_p, act0, movable0):
        """The plan's dict (see `make_repair_tools_plain`).  The anchors
        may be strided (a state loaded from a checkpoint holds its x in
        column order); the kernels read a contiguous copy."""
        x0_p = x0_p.contiguous()
        rs = _check_plan(c, x0_p, act0, movable0, sg, d)
        if x0_p.device.type == "cpu":
            face_fn = (None if faces is None
                       else slab_face_fn(faces, band, x0_p))
            return plan_plain(c, x0_p, act0, movable0, face_fn)
        return _plan_kernels(c, x0_p, movable0, rs, consts, d, repair_k)

    def apply(c, plan_d, also=(), anchors=None):
        """The repaired carry (see `make_repair_tools_plain`); strided
        `anchors` as the plan takes them."""
        if anchors is not None:
            anchors = anchors.contiguous()
        rs = _check_apply(c, plan_d, also, anchors, sg, d, repair_k)
        if c["addr"].pos.device.type == "cpu":
            return apply_plain(c, plan_d, also, anchors)
        return _apply_kernels(c, plan_d, also, anchors, rs, sg, d, repair_k)

    return plan, apply


def _plan_kernels(c, x0_p, movable0, rs, consts, d, repair_k) -> dict:
    addr = c["addr"]
    dev = x0_p.device
    cap_n = x0_p.shape[0]
    lib = _build.library("repair_kernels")
    if lib.repair_consts_bytes() != ctypes.sizeof(consts):
        raise RuntimeError("repair._RepairConsts does not mirror the CUDA "
                           "source's RepairConsts")
    i32 = dict(dtype=torch.int32, device=dev)
    out = dict(
        can=torch.empty((), dtype=torch.bool, device=dev),
        n_risky=torch.empty((), **i32),
        pids=torch.empty(repair_k, dtype=torch.int64, device=dev),
        vm=torch.empty(repair_k, dtype=torch.bool, device=dev),
        x_m=torch.empty((repair_k, d), dtype=torch.float32, device=dev),
        old_row=torch.empty(repair_k, **i32),
        old_pos=torch.empty(repair_k, **i32),
        new_row=torch.empty(repair_k, **i32),
        new_pos=torch.empty(repair_k, **i32),
    )
    scratch = torch.empty(lib.repair_scratch_ints(cap_n, repair_k), **i32)
    rc = lib.repair_plan(
        c["xs"].data_ptr(), rs[0], c["vs"].data_ptr(), rs[1],
        addr.valid.data_ptr(), addr.row_pos.data_ptr(), addr.pos.data_ptr(),
        addr.row_code.data_ptr(), addr.n_occ.data_ptr(), x0_p.data_ptr(),
        movable0.data_ptr(), cap_n, repair_k,
        *(out[k].data_ptr() for k in (
            "pids", "vm", "x_m", "old_row", "old_pos", "new_row", "new_pos",
            "n_risky", "can")),
        scratch.data_ptr(), ctypes.addressof(consts), d, dev.index or 0,
        _stream(dev))
    _raise_on(rc, "repair_plan")
    for name in ("repair_particles", "repair_movers", "repair_lanes"):
        _count(name)
    return out


def _apply_kernels(c, plan_d, also, anchors, rs, sg, d, repair_k) -> dict:
    addr = c["addr"]
    dev = addr.pos.device
    lib = _build.library("repair_kernels")
    sets = [(c["xs"], c["vs"], c["acc"], rs["xs"], rs["vs"], rs["acc"])] + [
        (h.xs, h.vs, h.acc, rs[f"xs{i}"], rs[f"vs{i}"], rs[f"acc{i}"])
        for i, h in enumerate(also)]
    n_sets = len(sets)
    ptrs = [(ctypes.c_void_p * n_sets)(*(s[j].data_ptr() for s in sets))
            for j in range(3)]
    strides = [(ctypes.c_int * n_sets)(*(s[3 + j] for s in sets))
               for j in range(3)]
    pos = torch.empty_like(addr.pos)
    row_pos = torch.empty_like(addr.row_pos)
    gcounts = torch.empty_like(addr.gcounts)
    stash = torch.empty((repair_k, 2 * d + 2), dtype=torch.float32,
                        device=dev)
    anchors_out = None if anchors is None else torch.empty_like(anchors)
    n = addr.pos.shape[0]
    rc = lib.repair_apply(
        *ptrs, *strides, n_sets,
        c["x0s"].data_ptr(), rs["x0s"], c["rp"].data_ptr(), rs["rp"],
        c["movb"].data_ptr(), rs["movb"],
        *(plan_d[k].data_ptr() for k in (
            "vm", "x_m", "old_row", "old_pos", "new_row", "new_pos", "pids")),
        stash.data_ptr(), addr.pos.data_ptr(), pos.data_ptr(),
        addr.row_pos.data_ptr(), row_pos.data_ptr(), n,
        addr.gcounts.data_ptr(), gcounts.data_ptr(), gcounts.numel(),
        anchors.data_ptr() if anchors is not None else None,
        anchors_out.data_ptr() if anchors is not None else None,
        anchors.shape[0] if anchors is not None else 0,
        repair_k, sg.lanes, sg.n_groups, d, _copy_blocks(dev, n),
        dev.index or 0, _stream(dev))
    _raise_on(rc, "repair_apply")
    _count("repair_copy")
    _count("repair_patch")
    addr2 = dataclasses.replace(addr, pos=pos, row_pos=row_pos,
                                gcounts=gcounts)
    out = {**c, "addr": addr2}
    if anchors is not None:
        out["anchors"] = anchors_out
    return out


def _copy_blocks(dev, n: int) -> int:
    """repair_copy's grid: 4 blocks of 256 threads an SM, at most one for
    each 256 elements of the addressing."""
    return max(1, min((n + 255) // 256, 4 * _sm_count(dev.index or 0)))
