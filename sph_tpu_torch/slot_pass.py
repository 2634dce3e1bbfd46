"""The resident block's per-step body in slot space: `slot_pre` before K1
and `slot_post` after K2, wrappers around the CUDA kernels in
`csrc/slot_pass_kernels.cu`, their plain PyTorch versions, and their launch
counts.

They have no Pallas counterpart: on the TPU, XLA fuses this body inside the
resident `lax.scan` (`run_block`, sph_tpu/step.py:1032-1093, with
`_SlotPhysics.body_forces` :557, `clamp_slot` :579, `mk_feat_builder`
:628-651 and `_membership_bad` :325).  A block keeps its state in a
`SlotBlock`: the fp32 feature array that K1/K2 read,

  feat [c_rows, 8, lanes] = x(3) | 0 | v(3) | 0 | mov | 0,

is also the block's storage of x and v (`SlotBlock.xs`, `.vs` are views of
it), so no step concatenates a feature array; bf16 features add
`feat16` = bf16(x − center) | 0 | bf16(v) | 0, rewritten each step.

  slot_pre   leapfrog kick and drift into `feat` (and `feat16`)
  slot_post  body forces, acceleration, second half-kick or Euler update,
             clamp walls, drift audit relaxed by build-cell membership;
             the violations added into `SlotBlock.count`

Both update in place and visit only the occupied 128-lane groups (rows
1..n_occ, gcounts > 0), as K1/K2 do: the plain sequence leaves an empty
slot unchanged bit for bit, so the whole arrays come out the same.  A
block's first `slot_pre` (`first=True`) reads the carry, the block's top,
and writes the block's own storage, since the top stays as it is for a
heal to re-run from and a repair to plan on.  The storage outlives the
block (`SlotStore`): the two arrays alternate, and the one that held the
last accepted block's top already holds, outside the occupied groups,
what a pass over every slot would write there.  So the first pass visits
the occupied groups too; only a storage not yet filled under the block's
addressing gets the pass over every slot (`full=True`, which also zeroes
acc).

The plain versions are the PyTorch sequence the resident block ran before
these kernels, op for op, writing only where the kernels write; they run
for CPU tensors.  A wrapper given CUDA tensors launches its kernel
(building it at first use) or raises.  `LAUNCHES` counts kernel launches
only (none while a CUDA graph is captured).  What bounds the kernels on
the card, and how they reproduce PyTorch's rounding, is noted in the CUDA
source; PERF.md holds their times.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sph_tpu_torch import _build
from sph_tpu_torch.platform import device_const
from sph_tpu_torch.slot_kernels import FEAT, LANE, _f32, _raise_on, _stream

#: kernel launches per wrapper since the last `reset_launches()`
LAUNCHES = {"slot_pre": 0, "slot_post": 0}

#: resident blocks run on a `SlotStore` since the last `reset_launches()`:
#: by their first slot_pre, over every slot (`full`) or over the occupied
#: groups (`occupied`), and by where their top came from: a build of the
#: addressing, a repair of it, or the block before (`plain`)
BLOCKS = {"full": 0, "occupied": 0, "after_build": 0, "after_repair": 0,
          "plain": 0}

#: True: every block runs on fresh storage with the full first pass, as
#: before the storage outlived the block; the sequence the persistent
#: storage is held to, bit for bit
FRESH_STORAGE = False


def reset_launches() -> None:
    for counts in (LAUNCHES, BLOCKS):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Membership of a slot in its build cell
# ---------------------------------------------------------------------------
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


def slot_bin_refs(addr, sg) -> list:
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


def slot_inside_bin(xs, refs, grid, ci_offset=None):
    """[c_rows, 1, lanes] bool: the slot's CURRENT position still bins into
    its build cell, with `neighbors.cell_index`'s floor and clip, so
    'inside' is exactly 'a rebuild would bin it identically'.  `ci_offset`
    (D ints) is a slab-local lattice's index shift (`decomp.py`): the refs
    are local indices."""
    cell = device_const(grid.cell, xs.dtype, xs.device)
    ins = None
    for a in range(xs.shape[1]):
        if refs[a] is None:
            continue
        lo = device_const(grid.lo[a], xs.dtype, xs.device)
        ci = torch.floor((xs[:, a, :] - lo) / cell).to(torch.int32)
        if ci_offset is not None:
            ci = ci - ci_offset[a]
        ci = torch.clamp(ci, 0, grid.shape[a] - 1)
        eq = ci == refs[a]
        ins = eq if ins is None else ins & eq
    return ins[:, None, :]


def membership_bad(bad, xs, refs, grid, ci_offset=None, beyond=None):
    """Relax a strict drift-audit mask by membership: a violation is real
    only once the slot ALSO left its build cell — except where `beyond`
    (a slab decomposition's beyond-the-face mask) holds, which keeps the
    strict form."""
    keep = ~slot_inside_bin(xs, refs, grid, ci_offset)
    if beyond is not None:
        keep = keep | beyond
    return bad & keep


def slot_bin_margin(xs, refs, grid, ci_offset=None):
    """[c_rows, 1, lanes]: distance to the nearest face of the slot's build
    cell (negative once outside); an exempt axis contributes no face."""
    m = None
    for a in range(xs.shape[1]):
        ref = refs[a]
        if ref is None:
            continue
        if ci_offset is not None:
            ref = ref + ci_offset[a]
        lo_c = ref.to(xs.dtype) * grid.cell + grid.lo[a]
        ma = torch.minimum(xs[:, a, :] - lo_c, lo_c + grid.cell - xs[:, a, :])
        m = ma if m is None else torch.minimum(m, ma)
    return m[:, None, :]


def membership_risky(c, grid, dd2, dt, sort_every, budget, ci_offset=None,
                     extra_margin=None):
    """[c_rows, 1, lanes] bool: the rebuild predicate's per-slot AND — the
    next block's 1.2×-projected move can BOTH take the slot out of its
    build cell (or past `extra_margin`, the slab-face distance of a
    decomposition: leavers keep the strict budget) AND past the drift
    budget.  The one definition for the single-device and slab advances."""
    vs = c["vs"]
    speed = torch.sqrt(torch.sum(vs * vs, dim=1, keepdim=True))
    move = (1.2 * dt * sort_every) * speed
    marg = slot_bin_margin(c["xs"], c["refs"], grid, ci_offset)
    if extra_margin is not None:
        marg = torch.minimum(marg, extra_margin)
    return c["movb"] & (marg < move) & (torch.sqrt(dd2) + move > budget)


def face_beyond(faces, xs):
    """[c_rows, 1, lanes] bool: the slot is past an interior face of
    `faces` (a `decomp._Slab`)."""
    go_left, go_right = faces.beyond(xs[:, faces.axis:faces.axis + 1, :])
    return go_left | go_right


def face_margin(faces, xs):
    """[c_rows, 1, lanes]: the slot's distance to the nearest interior face
    of `faces` (a `decomp._Slab`; inf at a domain wall)."""
    return faces.face_margin(xs[:, faces.axis:faces.axis + 1, :])


# ---------------------------------------------------------------------------
# The block's storage and constants
# ---------------------------------------------------------------------------


class SlotBlock:
    """One resident block's storage: `feat` (fp32, K1/K2's features and the
    block's x and v), `feat16` (bf16 features, or None), `acc` [c_rows, d,
    lanes], the violation `count` and the `risky` slots of the rebuild
    predicate at its end (int32, 0-d).  `feat` and `acc` may be given: a
    build's scatter array and its zero acc.  `addr` is the addressing
    under which its slots outside the occupied groups hold what a full
    first pass writes there (None: not filled)."""

    def __init__(self, c_rows: int, lanes: int, d: int, bf16: bool,
                 device, feat=None, acc=None) -> None:
        f32 = torch.float32
        self.d = d
        self.feat = (torch.empty((c_rows, FEAT, lanes), dtype=f32,
                                 device=device) if feat is None else feat)
        self.feat16 = (torch.empty((c_rows, FEAT, lanes),
                                   dtype=torch.bfloat16, device=device)
                       if bf16 else None)
        self.acc = (torch.empty((c_rows, d, lanes), dtype=f32, device=device)
                    if acc is None else acc)
        self.count = torch.empty((), dtype=torch.int32, device=device)
        self.risky = torch.empty((), dtype=torch.int32, device=device)
        self.addr = None

    @property
    def xs(self):
        return self.feat[:, 0:self.d, :]

    @property
    def vs(self):
        return self.feat[:, 3:3 + self.d, :]

    @property
    def kernel_feat(self):
        """The features K1/K2 read."""
        return self.feat if self.feat16 is None else self.feat16


class SlotStore:
    """The storage of a dispatch's resident blocks, which outlives the
    block: at most two `SlotBlock`s that alternate.  A block writes the one
    that does not hold its top, the carry it starts from, nor the last
    block's storage (a carry rebuilt from the last block's end holds that
    block's arrays until the new block's verdict: the slab fast path heals
    such a block from them); once the block ran, its top's array is the
    next block's storage.

    Under one addressing, no pass writes a slot outside the occupied
    groups, so a storage filled once for it (`SlotBlock.addr`) holds there
    what a full first pass would write (x the build's empty value, v +0,
    acc +0): its first slot_pre visits the occupied groups only.  Any other
    storage gets the full pass.  A repair re-homes particles between
    groups, so it patches every filled storage at the same slots
    (`filled`) and re-keys them to its addressing (`readdress`).

    The build's own scatter array (the carry's `feat`, with its zero acc)
    joins as a storage once the first block after the build ran: that
    block's full pass copies the build's positions, the drift audit's
    reference `x0s` until then a view of the array, into the store's `x0`.
    With bf16 features, and for a carry whose x and v are not a feature
    array (the packed_scatter transport), the build's arrays do not join,
    and the first two blocks after a build get the full pass."""

    def __init__(self, sg, d: int, bf16: bool, device) -> None:
        self.make = (sg.c_rows, sg.lanes, d, bf16, device)
        self.bf16 = bf16
        self.halves: list[SlotBlock] = []
        self.last_blk = None    # the storage the last block ran in
        self.x0 = None
        self.last = None        # the addressing of the last block taken
        self.repaired = None    # the addressing the last repair made
        self._tiles = (None, None)

    def tiles(self, addr) -> tuple:
        """`occupied_tiles` of `addr`, made once per addressing."""
        if self._tiles[0] is not addr:
            self._tiles = (addr, occupied_tiles(addr.gcounts, addr.n_occ))
        return self._tiles[1]

    def take(self, c):
        """(storage, full, x0) for the block whose top is the carry `c`:
        the storage not holding the top, whether its first slot_pre runs
        over every slot, and the array it copies the top's x into (or
        None).  Counts the block in `BLOCKS`."""
        addr = c["addr"]
        kind = ("plain" if addr is self.last
                else "after_repair" if addr is self.repaired
                else "after_build")
        BLOCKS[kind] += 1
        self.last = addr
        if FRESH_STORAGE:
            BLOCKS["full"] += 1
            return SlotBlock(*self.make), True, None
        top = c["xs"].data_ptr()
        free = [h for h in self.halves
                if h.feat.data_ptr() != top and h is not self.last_blk]
        blk = next((h for h in free if h.addr is addr),
                   free[0] if free else None)
        if blk is None:
            blk = SlotBlock(*self.make)
            self.halves.append(blk)
        full = blk.addr is not addr
        x0 = None
        if full and self._joins(c) and c["x0s"].data_ptr() == top:
            if self.x0 is None:
                self.x0 = torch.empty_like(c["acc"])
            x0 = self.x0
        BLOCKS["full" if full else "occupied"] += 1
        blk.addr = None
        return blk, full, x0

    def done(self, c, blk) -> None:
        """The block from the top `c` ran in `blk`: `blk` is filled for
        `c`'s addressing, and the build's scatter array joins once its x
        was copied out."""
        if FRESH_STORAGE:
            return
        blk.addr = c["addr"]
        self.last_blk = blk
        if self._joins(c) and c["x0s"].data_ptr() != c["feat"].data_ptr():
            built = SlotBlock(*self.make, feat=c["feat"], acc=c["acc"])
            built.addr = c["addr"]
            self.halves = [blk, built]

    def _joins(self, c) -> bool:
        """The top is a build's own scatter array, in fp32."""
        feat = c.get("feat")
        return (not self.bf16 and feat is not None
                and c["xs"].data_ptr() == feat.data_ptr())

    def filled(self, c) -> list:
        """The storages besides `c`'s top filled for `c`'s addressing,
        which a repair of it patches."""
        top = c["xs"].data_ptr()
        return [h for h in self.halves
                if h.addr is c["addr"] and h.feat.data_ptr() != top]

    def readdress(self, old, new) -> None:
        """A repair turned addressing `old` into `new`, with every filled
        storage patched."""
        for h in self.halves:
            if h.addr is old:
                h.addr = new
        self.repaired = new


class SlotBody:
    """Elementwise physics in [c_rows, d, lanes] SLOT space — the exact
    per-element arithmetic of physics.gravity_force / wall_penalty_force /
    force_field_force / clamp_boundary, so integrating in slot space is
    bitwise integrating in particle space — and the same constants as
    `slot_post`'s kernel takes them (fp32 values; the force fields as
    device arrays, made once)."""

    def __init__(self, scene, grid, sg, device: torch.device):
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
            (device_const(tuple(ff.pos), f32, device).reshape(1, d, 1),
             device_const(ff.radius, f32, device), ff)
            for ff in scene.force_fields
        ]
        # the kernel's copy: per field pos(3), fp32(radius), strength;
        # start and stop steps
        n_f = len(scene.force_fields)
        ff_f = np.zeros((max(n_f, 1), 5), np.float32)
        ff_i = np.zeros((max(n_f, 1), 2), np.int32)
        for j, ff in enumerate(scene.force_fields):
            ff_f[j, :d] = ff.pos
            ff_f[j, 3] = ff.radius
            ff_f[j, 4] = ff.strength
            ff_i[j] = (ff.start_step, min(ff.stop_step, 2**31 - 1))
        self.ff_f = torch.from_numpy(ff_f).to(device)
        self.ff_i = torch.from_numpy(ff_i).to(device)

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
        for c, radius, ff in self.fields:
            dx = c - xs
            r = torch.sqrt(torch.sum(dx * dx, dim=1, keepdim=True))
            fall = torch.clamp(1.0 - r / radius, min=0.0)
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


class _PostConsts(ctypes.Structure):
    """The CUDA source's `PostConsts`, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "leap", "penalty", "clamp", "use_mem", "packed", "faces",
            "face_axis", "face_lo_on", "face_hi_on", "cap", "xc", "h1")]
        + [("shape", ctypes.c_int * 3), ("ci_off", ctypes.c_int * 3)]
        + [(n, ctypes.c_float) for n in (
            "dt", "c_half", "half2", "k_w", "c_w", "damping", "cell",
            "face_lo", "face_hi")]
        + [(n, ctypes.c_float * 3) for n in ("g", "lo_w", "hi_w", "lo")]
        + [("need", ctypes.c_int), ("move_k", ctypes.c_float),
           ("budget", ctypes.c_float)]
    )


class PostPlan:
    """What `slot_post` needs besides the arrays, fixed for a block: the
    body's physics, the integrator, the audit's (skin/2)², whether it is
    relaxed by membership (`use_mem`), a slab-local lattice's `ci_offset`
    and a slab's `faces` (a `decomp._Slab`); with a `budget`, the block's last slot_post also
    counts the slots of the membership rebuild predicate
    (`membership_risky` for the next block of `sort_every` steps, the
    faces its extra margin).  For the kernel, the same as one ctypes
    struct."""

    def __init__(self, body: SlotBody, leap: bool, half2: float,
                 use_mem: bool, ci_offset=None, faces=None,
                 budget: float | None = None, sort_every: int = 0):
        self.body, self.leap, self.half2 = body, leap, half2
        self.use_mem, self.ci_offset, self.faces = use_mem, ci_offset, faces
        self.budget, self.sort_every = budget, sort_every
        params, grid, sg, d = body.params, body.grid, body.sg, body.d
        self.dt = params.dt
        self.clamp = params.boundary_mode == "clamp"
        k = _PostConsts()
        k.leap, k.use_mem, k.packed = int(leap), int(use_mem), int(sg.packed)
        k.penalty = int(params.boundary_mode == "penalty")
        k.clamp = int(self.clamp)
        if faces is not None:
            k.faces, k.face_axis = 1, faces.axis
            k.face_lo_on = int(not faces.first)
            k.face_hi_on = int(not faces.last)
            k.face_lo, k.face_hi = _f32(faces.lo), _f32(faces.hi)
        k.cap, k.xc, k.h1 = sg.cap, sg.xc, sg.h1
        k.dt, k.c_half, k.half2 = (_f32(params.dt), _f32(0.5 * params.dt),
                                   _f32(half2))
        k.k_w, k.c_w = _f32(params.wall_stiffness), _f32(params.wall_damping)
        k.damping, k.cell = _f32(params.boundary_damping), _f32(grid.cell)
        eps = np.float32(params.wall_eps)
        for a in range(d):
            k.shape[a] = grid.shape[a]
            k.ci_off[a] = ci_offset[a] if ci_offset is not None else 0
            k.g[a] = _f32(params.gravity[a])
            k.lo_w[a] = np.float32(body.scene.lo[a]) + eps
            k.hi_w[a] = np.float32(body.scene.hi[a]) - eps
            k.lo[a] = _f32(grid.lo[a])
        if budget is not None:
            k.need = 1
            k.move_k = _f32(1.2 * params.dt * sort_every)
            k.budget = _f32(budget)
        self.consts = k


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _occupied(gcounts, n_occ):
    """[c_rows, n_groups] bool: the occupied 128-lane groups of rows
    1..n_occ."""
    rows = torch.arange(gcounts.shape[0], device=gcounts.device)
    live = (rows >= 1) & (rows <= n_occ)
    return (gcounts[:, 0, :] > 0) & live[:, None]


def occupied_tiles(gcounts, n_occ) -> tuple:
    """(tiles, n_tiles): the occupied (row, 128-lane group) tiles, row ·
    n_groups + group in row-major order, first in an int32 list of every
    tile's length, and their count, int32 [1], on the device (no host
    sync).  The kernels walk tiles[0..n_tiles); made once per
    addressing."""
    occ = _occupied(gcounts, n_occ).reshape(-1)
    n = occ.numel()
    pos = torch.cumsum(occ, 0, dtype=torch.int32)
    tiles = torch.zeros(n + 1, dtype=torch.int32, device=occ.device)
    tiles.index_put_((torch.where(occ, pos - 1, n).long(),),
                     torch.arange(n, dtype=torch.int32, device=occ.device))
    return tiles[:n], pos[-1:]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tile_blocks(dev, n: int) -> int:
    """The blocks that walk a tile list: enough to fill the card (16 blocks
    of 128 threads an SM), at most one a tile."""
    return min(n, 16 * _sm_count(dev.index or 0))


def _visit(gcounts, n_occ, lanes: int):
    """[c_rows, 1, lanes] bool: the slots of the occupied 128-lane groups
    of rows 1..n_occ, where the kernels write (no host sync)."""
    occ = _occupied(gcounts, n_occ)
    return occ.repeat_interleave(LANE, dim=1)[:, None, :]


def _put(dst, vals, visit) -> None:
    """dst = vals where `visit` (everywhere when None), in place."""
    dst.copy_(vals if visit is None else torch.where(visit, vals, dst))


def slot_pre_plain(blk: SlotBlock, xs, vs, acc, movb, gcounts, n_occ,
                   dt: float, kick: bool, drift: bool, first: bool,
                   centers=None, full=None, x0=None) -> None:
    """Plain version of `slot_pre` (same arguments)."""
    full = first if full is None else full
    d = blk.d
    c_rows, _, lanes = blk.feat.shape
    mov = movb.to(torch.float32)
    if x0 is not None:
        x0.copy_(xs)
    if kick:
        vs = vs + (0.5 * dt) * acc * mov
    if drift:
        xs = xs + dt * vs * mov
    zrow = torch.zeros((c_rows, 3 - d, lanes), device=xs.device)
    visit = None if full else _visit(gcounts, n_occ, lanes)
    if full:
        blk.feat.copy_(torch.cat([xs, zrow, vs, zrow, mov,
                                  torch.zeros_like(mov)], dim=1))
        blk.acc.zero_()
    else:
        if first or drift:
            _put(blk.xs, xs, visit)
        if first or kick:
            _put(blk.vs, vs, visit)
    if blk.feat16 is not None:
        z2 = torch.zeros((c_rows, 2, lanes), device=xs.device)
        _put(blk.feat16, torch.cat([xs - centers, zrow, vs, zrow, z2],
                                   dim=1).to(torch.bfloat16), visit)
    if first:
        blk.count.zero_()
        blk.risky.zero_()


def slot_post_plain(blk: SlotBlock, rp, f, x0s, movb, addr, plan: PostPlan,
                    step0, i: int, last: bool = False) -> None:
    """Plain version of `slot_post` (same arguments)."""
    body, d = plan.body, blk.d
    dt = plan.dt
    xs, vs = blk.xs, blk.vs
    mov = movb.to(torch.float32)
    rho_s = rp[:, 0:1, :]
    f_tot = body.body_forces(xs, vs, rho_s, f[:, 0:d, :], step0, i)
    a_s = torch.where(movb, f_tot / torch.clamp(rho_s, min=1e-12), 0.0)
    xs2 = xs
    if plan.leap:
        vs2 = vs + (0.5 * dt) * a_s
    else:
        vs2 = vs + dt * a_s * mov
        xs2 = xs + dt * vs2 * mov
    if plan.clamp:
        xs2, vs2 = body.clamp_slot(xs2, vs2, movb)
    dd = xs2 - x0s
    drift2 = torch.sum(dd * dd, dim=1, keepdim=True)
    bad = (drift2 > plan.half2) & movb
    refs = slot_bin_refs(addr, body.sg)
    faces = plan.faces
    if plan.use_mem:
        bad = membership_bad(bad, xs2, refs, body.grid, plan.ci_offset,
                             None if faces is None else face_beyond(faces, xs2))
    visit = _visit(addr.gcounts, addr.n_occ, blk.feat.shape[2])
    blk.count.add_(torch.sum(bad & visit, dtype=torch.int32))
    if last and plan.budget is not None:
        risky = membership_risky(
            dict(xs=xs2, vs=vs2, refs=refs, movb=movb), body.grid, drift2,
            dt, plan.sort_every, plan.budget, plan.ci_offset,
            None if faces is None else face_margin(faces, xs2))
        blk.risky.add_(torch.sum(risky & visit, dtype=torch.int32))
    if xs2 is not xs:
        _put(xs, xs2, visit)
    _put(vs, vs2, visit)
    _put(blk.acc, a_s, visit)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t, dtype, dev, shape, lanes: int = 0) -> int:
    """Raise on an array the kernels do not take; → its row stride.  A slot
    array (`lanes` given) has contiguous lanes and its components `lanes`
    apart; any other array is contiguous."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the block on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not lanes:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        return 0
    if t.stride(2) != 1 or t.stride(1) != lanes:
        raise ValueError(f"{name} must have contiguous lanes, components "
                         f"{lanes} apart")
    return t.stride(0)


def _tiles(tiles, gcounts, n_occ, dev) -> tuple:
    """`tiles` checked, or the tile list of `gcounts` and `n_occ` made."""
    if tiles is None:
        return occupied_tiles(gcounts, n_occ)
    tl, n_tiles = tiles
    _check("tiles", tl, torch.int32, dev, (gcounts.shape[0]
                                           * gcounts.shape[2],))
    _check("n_tiles", n_tiles, torch.int32, dev, (1,))
    return tl, n_tiles


def _count(name: str) -> None:
    if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing
        LAUNCHES[name] += 1


def slot_pre(blk: SlotBlock, xs, vs, acc, movb, gcounts, n_occ, dt: float,
             kick: bool, drift: bool, first: bool, centers=None, full=None,
             x0=None, tiles=None) -> None:
    """The step's kick (`kick`: v += fp32(dt/2)·acc·mov) and drift
    (`drift`: x += fp32(dt)·v·mov) of `xs`, `vs` into `blk.feat` (and the
    bf16 view into `blk.feat16`, relative to `centers` [c_rows, d,
    lanes]), over the occupied groups of `gcounts` [c_rows, 1, n_groups]
    and `n_occ` [1].  `first`: the block's first pass, from the top's
    arrays into the block's storage, with `blk.count` and `blk.risky`
    zeroed; else in place (`xs`, `vs`, `acc` are the block's own).
    `full` (default: `first`): a first pass over every slot, which also
    writes the pads and mov and zeroes `blk.acc`, and with `x0` [c_rows,
    d, lanes] copies the top's x into it.  `tiles`: the addressing's
    `occupied_tiles` (made here when not given)."""
    full = first if full is None else full
    if full and not first:
        raise ValueError("a full slot_pre is a block's first")
    d = blk.d
    c_rows, _, lanes = blk.feat.shape
    dev = blk.feat.device
    shape = (c_rows, d, lanes)
    rs = [_check(n, t, torch.float32, dev, shape, lanes)
          for n, t in (("xs", xs), ("vs", vs))]
    a_rs = _check("acc", acc, torch.float32, dev, shape, lanes) if kick else 0
    _check("movb", movb, torch.bool, dev, (c_rows, 1, lanes))
    _check("gcounts", gcounts, torch.int32, dev, (c_rows, 1, lanes // LANE))
    _check("n_occ", n_occ, torch.int32, dev, (1,))
    bf16 = blk.feat16 is not None
    if bf16:
        _check("centers", centers, torch.float32, dev, shape)
    if x0 is not None:
        if not full:
            raise ValueError("x0 is copied by a full slot_pre")
        _check("x0", x0, torch.float32, dev, shape)
    own = (xs.data_ptr() == blk.xs.data_ptr()
           and vs.data_ptr() == blk.vs.data_ptr())
    if own == first:
        raise ValueError("an in-place slot_pre takes the block's own xs, vs;"
                         " a block's first the top's")
    if dev.type == "cpu":
        return slot_pre_plain(blk, xs, vs, acc, movb, gcounts, n_occ, dt,
                              kick, drift, first, centers, full, x0)
    n_groups = lanes // LANE
    tl, n_tiles = (None, None) if full else _tiles(tiles, gcounts, n_occ, dev)
    lib = _build.library("slot_pass_kernels")
    rc = lib.slot_pre(
        xs.data_ptr(), rs[0], vs.data_ptr(), rs[1],
        acc.data_ptr() if kick else None, a_rs, movb.data_ptr(),
        blk.feat.data_ptr(), blk.feat16.data_ptr() if bf16 else None,
        centers.data_ptr() if bf16 else None,
        blk.acc.data_ptr(), x0.data_ptr() if x0 is not None else None,
        blk.count.data_ptr(), blk.risky.data_ptr(),
        tl.data_ptr() if tl is not None else None,
        n_tiles.data_ptr() if tl is not None else None,
        _tile_blocks(dev, c_rows * n_groups), c_rows, lanes, n_groups, d,
        int(first), int(full), int(kick), int(drift), _f32(0.5 * dt),
        _f32(dt), dev.index or 0, _stream(dev))
    _raise_on(rc, "slot_pre")
    _count("slot_pre")


def slot_post(blk: SlotBlock, rp, f, x0s, movb, addr, plan: PostPlan,
              step0, i: int, last: bool = False, tiles=None) -> None:
    """The rest of step `step0 + i` after K2, in place on `blk` over the
    occupied groups of `addr`: body forces from K1's `rp` and K2's `f`,
    acc, the second half-kick (or Euler's v and x), clamp walls, and the
    drift audit against `x0s` (the build's positions) added into
    `blk.count`; at the block's `last` step, with a `plan.budget`, the
    rebuild predicate's slots added into `blk.risky`.  `step0` is the
    block's first step, an int32 0-d tensor read on the device; `tiles`
    the addressing's `occupied_tiles` (made here when not given)."""
    d = blk.d
    c_rows, _, lanes = blk.feat.shape
    dev = blk.feat.device
    x0_rs = _check("x0s", x0s, torch.float32, dev, (c_rows, d, lanes), lanes)
    _check("rp", rp, torch.float32, dev, (c_rows, 2, lanes))
    _check("f", f, torch.float32, dev, (c_rows, 4, lanes))
    _check("movb", movb, torch.bool, dev, (c_rows, 1, lanes))
    _check("row_code", addr.row_code, torch.int32, dev, (c_rows,))
    _check("gcounts", addr.gcounts, torch.int32, dev,
           (c_rows, 1, lanes // LANE))
    _check("n_occ", addr.n_occ, torch.int32, dev, (1,))
    body = plan.body
    if body.fields:
        _check("step0", step0, torch.int32, dev, ())
    if dev.type == "cpu":
        return slot_post_plain(blk, rp, f, x0s, movb, addr, plan, step0, i,
                               last)
    n_groups = lanes // LANE
    tl, n_tiles = _tiles(tiles, addr.gcounts, addr.n_occ, dev)
    lib = _build.library("slot_pass_kernels")
    n_f = len(body.fields)
    rc = lib.slot_post(
        blk.feat.data_ptr(), blk.acc.data_ptr(), rp.data_ptr(), f.data_ptr(),
        x0s.data_ptr(), x0_rs, movb.data_ptr(), addr.row_code.data_ptr(),
        tl.data_ptr(), n_tiles.data_ptr(),
        _tile_blocks(dev, c_rows * n_groups),
        step0.data_ptr() if n_f else None, i,
        body.ff_f.data_ptr(), body.ff_i.data_ptr(), n_f,
        blk.count.data_ptr(), blk.risky.data_ptr(),
        int(last and plan.budget is not None), ctypes.addressof(plan.consts),
        lanes, n_groups, d, dev.index or 0, _stream(dev))
    _raise_on(rc, "slot_post")
    _count("slot_post")
