"""The slot-layout and packed-row density + force pass (port of
`sph_tpu/pallas_step.py`).

Layout, kept from the reference so per-particle results compare one to one:

  1. Row compaction: only occupied (z, y) cell rows exist in memory, at
     compacted positions 1..n_occ.  Position 0 is a reserved always-empty
     DUMMY row (positions 1e18, rho 0).  Every neighbor-row lookup that
     misses (row unoccupied, outside the grid, or dropped by the c_rows cap)
     routes to row 0, whose features annihilate every pair term, so the
     kernels need no validity masks.
  2. One scatter packs per-particle features [x | v] into
     feat[c_rows, FEAT, lanes]: feature axis in the middle, (x slot-cell ·
     cap) on the lanes, with a one-group (128-lane) x halo on each side so
     every candidate window is in bounds.  `GridSpec.xsub` > 1 splits each
     x cell into xsub slot-cells of cap/xsub slots; the candidate margin is
     then xsub slot-cells, one full cell.  With `precision="bf16"` the
     features are bf16, positions relative to the build-time cell center
     (`SlotAddr.center`, `_rel_rows`).  `staged=True` scatters into a
     feature-minor staging array instead and transposes it with K5
     (`stage_kernels.py`, `csrc/stage_kernels.cu`); the result is the same.
  3. The density kernel (K1) reads the 3^(D-1) neighbor rows of each row
     through the int32 table `nbr_pos[R, c_rows]`, sums poly6 over the
     ±xsub x slot-cells, applies the EOS, and writes lane-major (rho, p) rows
     rp[c_rows, 2, lanes].  The force kernel (K2) streams the same rows of
     feat and rp and writes f[c_rows, FOUT, lanes].  Both are hand-written
     CUDA (`slot_kernels.py`, `csrc/slot_kernels.cu`); on CPU tensors they
     run their plain PyTorch versions.
  4. Per-particle values are element-gathered back from the slot arrays.

The packed-row layout (`packed_grid`, `SlotGrid.packed`) is the sparse-scene
variant: a row's particles fill lanes 0..count-1 in stable rank order, there
are no per-cell slots and no x halo, and the kernels (K3, K4:
`packed_kernels.py`, `csrc/packed_kernels.cu`) pair each particle with every
particle of the 3^(D-1) neighbor rows; compact support annihilates the
far-x pairs.  Row compaction, the dummy row, the scatter and the gathers
are shared with the slot layout.

All index work stays on the device with no host sync: the kernels read
`n_occ` from device memory.  Where JAX drops out-of-range scatter indices
(`mode="drop"`) or pads `nonzero`, this module writes such entries to one
spare dump element that is sliced off afterwards.

Capacity semantics (the reference's): a particle with cell rank >= cap drops
out of the slots and falls back to rest density / zero pair force; rows past
the c_rows cap drop the same way; `SlotAddr.overflow` counts both.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sph_tpu_torch import packed_kernels, physics, slot_kernels, stage_kernels
from sph_tpu_torch.neighbors import GridSpec, cell_index
from sph_tpu_torch.params import SimParams
from sph_tpu_torch.platform import device_const, span
from sph_tpu_torch.slot_kernels import FEAT, FOUT, LANE


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class SlotGrid:
    """Static slot-grid geometry derived from a GridSpec.

    Rows = compacted occupied (z, y) rows (c_rows incl. the dummy row 0);
    lanes = (x-cell · cap), padded to 128-lane groups of XC = 128/cap cells
    with a one-group halo on each side.
    """

    inner: tuple[int, ...]   # GridSpec.shape
    cap: int                 # slot-cell capacity (cap / xsub); divides 128
    c_rows: int              # compacted-row capacity incl. dummy row 0
    cell: float = 0.0        # GridSpec.cell (the bf16 features' frame)
    xsub: int = 1            # x slot-cells per cell (GridSpec.xsub)
    packed: bool = False     # packed-row layout: a row's particles occupy
    #                          lanes 0..count-1 (pos = within-row rank)
    row_lanes: int = 0       # packed: static per-row particle capacity
    #                          (multiple of 128); overflow is audited like
    #                          the cell cap

    @property
    def dim(self) -> int:
        return len(self.inner)

    @property
    def xc(self) -> int:     # cells per 128-lane group
        return LANE // self.cap

    @property
    def h0(self) -> int:     # z rows incl. halo (1 for 2D)
        return self.inner[0] + 2 if self.dim == 3 else 1

    @property
    def h1(self) -> int:     # y rows incl. halo
        return self.inner[-2] + 2

    @property
    def h2(self) -> int:     # x slot-cells per row incl. one-group halos
        return _round_up(self.inner[-1] * self.xsub, self.xc) + 2 * self.xc

    @property
    def n_groups(self) -> int:
        if self.packed:
            return self.row_lanes // LANE
        return self.h2 // self.xc

    @property
    def lanes(self) -> int:
        if self.packed:
            return self.row_lanes
        return self.h2 * self.cap

    @property
    def row_offsets(self) -> tuple[tuple[int, int], ...]:
        if self.dim == 2:
            return tuple((0, dy) for dy in (-1, 0, 1))
        return tuple((dz, dy) for dz in (-1, 0, 1) for dy in (-1, 0, 1))


def _c_rows(grid: GridSpec, c_rows: int | None) -> int:
    dim = len(grid.shape)
    inner_rows = (grid.shape[0] + 2 if dim == 3 else 1) * (grid.shape[-2] + 2)
    if c_rows is None:
        # always-correct when the row space is small; else a documented cap
        c_rows = inner_rows if inner_rows <= 4096 else 4096
    return min(c_rows, inner_rows) + 1  # +1: reserved dummy row 0


def slot_grid(grid: GridSpec, c_rows: int | None = None,
              row_pair: bool = False) -> SlotGrid:
    if grid.cap % grid.xsub != 0:
        raise ValueError(
            f"cap {grid.cap} must be divisible by xsub {grid.xsub}")
    cap_slot = grid.cap // grid.xsub
    if LANE % cap_slot != 0:
        raise ValueError(
            f"the slot path needs slot cap | 128, got {cap_slot} "
            f"(cap {grid.cap} / xsub {grid.xsub})")
    c_rows = _c_rows(grid, c_rows)
    if row_pair and c_rows % 2:
        # the reference maps two rows to one Pallas program and pads c_rows
        # even; the CUDA kernels take one block per (128-lane group, row)
        # and need only the padding, which the addressing follows
        c_rows += 1
    return SlotGrid(inner=grid.shape, cap=cap_slot, c_rows=c_rows,
                    cell=grid.cell, xsub=grid.xsub)


def packed_grid(grid: GridSpec, row_lanes: int | None = None,
                c_rows: int | None = None) -> SlotGrid:
    """Packed-row SlotGrid (see SlotGrid.packed).  `row_lanes` is the static
    per-row particle capacity (rounded up to 128); the default sizes it at
    half a full row of the slot cap, and overflow is audited exactly like
    the cell cap."""
    if grid.xsub != 1:
        raise ValueError("packed rows do not compose with xsub")
    if row_lanes is None:
        row_lanes = max(256, grid.cap * grid.shape[-1] // 2)
    return SlotGrid(
        inner=grid.shape,
        cap=grid.cap,     # kept for GridSpec parity/audit surfaces only
        c_rows=_c_rows(grid, c_rows),
        cell=grid.cell,
        packed=True,
        row_lanes=_round_up(row_lanes, LANE),
    )


# ---------------------------------------------------------------------------
# Slot addressing, row compaction, scatters
# ---------------------------------------------------------------------------


def cell_ranks(flat: torch.Tensor, n_rows: int):
    """Within-cell rank per particle (stable: ascending original index)."""
    n = flat.shape[0]
    flat = flat.long()
    order = torch.argsort(flat, stable=True)
    sorted_flat = flat[order]
    counts = torch.zeros(n_rows, dtype=torch.int64, device=flat.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n, device=flat.device) - starts[sorted_flat]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return rank.to(torch.int32)


def _pack_rows6(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[N, 6] scatter rows: x(3) | v(3) (2D pads the third component)."""
    n, d = x.shape
    pad = torch.zeros((n, 3 - d), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad, v, pad], dim=1)


@dataclass(frozen=True)
class SlotAddr:
    """Per-particle slot addressing + row compaction, built once per step
    (or once per `sort_every` block: positions may then go stale by up to
    skin/2, see GridSpec.for_scene).
    Every field is equal, element for element, to the reference's
    (`sph_tpu.pallas_step.SlotAddr`)."""

    pos: torch.Tensor        # [N] i32 lane position hx·cap + rank
    #   (packed rows: the stable rank within the (z, y) row)
    valid: torch.Tensor      # [N] bool in a real cell and within cap
    row_pos: torch.Tensor    # [N] i32 compacted row of the particle's (z, y)
    #   row; 0 (= the dummy row) iff the row was dropped by the c_rows cap
    gcounts: torch.Tensor    # [c_rows, 1, n_groups] i32 per-group occupancy
    n_occ: torch.Tensor      # [1] i32 number of real compacted rows
    nbr_pos: torch.Tensor    # [R, c_rows] i32 compacted position of each
    #   neighbor row; 0 (dummy) when unoccupied, outside the grid, or dropped
    overflow: torch.Tensor   # [] i32 particles dropped by the static caps
    row_code: torch.Tensor   # [c_rows] i32 halo (z, y) row code of each
    #   compacted row (entry 0 = dummy)
    center: torch.Tensor     # [N, D] fp32 center of the cell
    #   (in x: slot-cell) each particle was binned into at build time — the
    #   bf16 cell-relative frame, fixed for the whole reuse window

    def ok(self) -> torch.Tensor:
        """[N] bool — the particle has a slot (in a cell, within both caps)."""
        return self.valid & (self.row_pos > 0)


def build_addr(x: torch.Tensor, active: torch.Tensor, grid: GridSpec,
               sg: SlotGrid, ci_offset: tuple[int, ...] | None = None
               ) -> SlotAddr:
    """`ci_offset` (D ints) places a slab-local grid on the global lattice
    (`neighbors.cell_index`); `center` stays in global coordinates."""
    with span("sph.build_addr"):
        n = x.shape[0]
        dev = x.device
        i32 = torch.int32
        ci, flat = cell_index(x, active, grid, ci_offset)
        in_cell = flat < grid.n_cells
        h0 = ((ci[:, 0] + 1) if sg.dim == 3
              else torch.zeros(n, dtype=i32, device=dev))
        h1 = ci[:, -2] + 1
        code = h0 * sg.h1 + h1                     # (z, y) row code, interior
        n_codes = sg.h0 * sg.h1
        if sg.packed:
            # pos = stable rank within the (z, y) row: a row's particles fill
            # lanes 0..count-1, so per-group occupancy is a prefix.  A particle
            # past row_lanes is not valid; the clamp only keeps its group index
            # in range (it adds nothing to gcounts).
            rank = cell_ranks(torch.where(in_cell, code, n_codes), n_codes + 1)
            valid = in_cell & (rank < sg.lanes)
            pos = rank
            gx = torch.clamp(rank, max=sg.lanes - 1) // LANE
        else:
            if sg.xsub == 1:
                sx = ci[:, -1]
            else:
                # the xsub-subdivided lattice, clamped into the full cell ci
                # assigned (so rounding between the two floors can never split
                # row and lane binning); divides by a device scalar, as
                # cell_index does
                lo_x = device_const(grid.lo[-1], x.dtype, dev)
                cell_x = device_const(grid.cell / sg.xsub, x.dtype, dev)
                sxf = torch.floor((x[:, -1] - lo_x) / cell_x).to(i32)
                if ci_offset is not None:
                    sxf = sxf - int(ci_offset[-1]) * sg.xsub
                base_sx = ci[:, -1] * sg.xsub
                sx = torch.minimum(torch.maximum(sxf, base_sx),
                                   base_sx + (sg.xsub - 1))
            hx = sx + sg.xc                        # one-group x halo
            n_hrows = sg.h0 * sg.h1 * sg.h2
            hrow = code * sg.h2 + hx
            hrow = torch.where(in_cell, hrow, n_hrows)
            rank = cell_ranks(hrow, n_hrows + 1)
            valid = in_cell & (rank < sg.cap)
            pos = hx * sg.cap + rank
            gx = hx // sg.xc

        row_occ = torch.zeros(n_codes + 1, dtype=i32, device=dev)
        row_occ.index_add_(
            0, torch.where(valid, code, n_codes).long(),
            torch.ones(n, dtype=i32, device=dev),
        )
        row_occ = row_occ[:n_codes] > 0
        usable = sg.c_rows - 1                     # row 0 is the dummy
        n_occ = torch.clamp(torch.sum(row_occ, dtype=i32),
                            max=usable).reshape(1)
        # padded nonzero(row_occ, size=usable, fill_value=0): the k-th occupied
        # code goes to slot k; codes past `usable` and unoccupied codes go to
        # the spare dump slot `usable`, sliced off below
        k = torch.cumsum(row_occ, 0, dtype=torch.int64) - 1
        codes = torch.arange(n_codes, dtype=i32, device=dev)
        row_codes = torch.zeros(usable + 1, dtype=i32, device=dev)
        row_codes.index_put_(
            (torch.where(row_occ & (k < usable), k, usable),), codes
        )
        row_codes = row_codes[:usable]
        in_range = torch.arange(usable, dtype=i32, device=dev) < n_occ[0]
        # row_inv: code -> compacted position (1..n_occ); 0 = dummy for
        # unoccupied/dropped rows.  Pad entries write 0 to the spare slot
        # n_codes so they cannot clobber a real code.
        targets = torch.where(in_range, row_codes, n_codes).long()
        row_inv = torch.zeros(n_codes + 1, dtype=i32, device=dev)
        row_inv.index_put_(
            (targets,),
            torch.where(in_range,
                        1 + torch.arange(usable, dtype=i32, device=dev), 0),
        )
        row_pos = row_inv[code.long()]        # 0 iff dropped by c_rows cap
        ok = valid & (row_pos > 0)
        overflow = (
            torch.sum((~valid) & in_cell, dtype=i32)
            + torch.sum(valid & (row_pos == 0), dtype=i32)
        )

        gcounts = torch.zeros(sg.c_rows * sg.n_groups, dtype=i32, device=dev)
        gcounts.index_add_(
            0, torch.where(ok, row_pos * sg.n_groups + gx, 0).long(),
            ok.to(i32)
        )
        gcounts = gcounts.reshape(sg.c_rows, 1, sg.n_groups)

        # Neighbor table in compacted space.  Occupied codes are interior, so
        # code + dz·H1 + dy stays in [0, n_codes) for real rows; the dummy/pad
        # entries use a safe interior code so the lookup stays in range.
        safe_code = sg.h1 + 1 if sg.dim == 3 else 1
        codes_ext = torch.cat([
            torch.full((1,), safe_code, dtype=i32, device=dev),
            torch.where(in_range, row_codes, safe_code),
        ])
        offs = device_const(
            tuple(dz * sg.h1 + dy for dz, dy in sg.row_offsets), i32, dev)
        nbr_idx = torch.clamp(codes_ext[None, :] + offs[:, None], 0, n_codes)
        nbr_pos = row_inv[nbr_idx.long()]
        # the dummy row's own neighbors stay the dummy row
        nbr_pos[:, 0] = 0
        lo = device_const(grid.lo, x.dtype, dev)
        cell = device_const(grid.cell, x.dtype, dev)
        if ci_offset is not None:
            ci = ci + device_const(tuple(ci_offset), i32, dev)
            if sg.xsub > 1 and not sg.packed:
                sx = sx + int(ci_offset[-1]) * sg.xsub
        center = lo + (ci.to(x.dtype) + 0.5) * cell
        if sg.xsub > 1:    # x: the slot-cell center (the lane binning)
            cx = (device_const(grid.lo[-1], x.dtype, dev)
                  + (sx.to(x.dtype) + 0.5)
                  * device_const(grid.cell / sg.xsub, x.dtype, dev))
            center = torch.cat([center[:, :-1], cx[:, None]], dim=1)
        return SlotAddr(
            pos=pos, valid=valid, row_pos=row_pos, gcounts=gcounts,
            n_occ=n_occ, nbr_pos=nbr_pos.contiguous(), overflow=overflow,
            row_code=codes_ext, center=center,
        )


def _flat_slot_idx(addr: SlotAddr, sg: SlotGrid, ncols: int, dump: int):
    """[N, ncols] int64 flat element indices of each particle's feature
    slots in the flattened feat array; particles without a slot point at
    the spare element `dump` (the reference's out-of-bounds index that a
    mode='drop' scatter skips)."""
    ok = addr.ok()
    base = addr.row_pos.long() * (FEAT * sg.lanes) + addr.pos.long()
    cols = torch.arange(ncols, device=base.device) * sg.lanes
    return torch.where(ok[:, None], base[:, None] + cols[None, :], dump)


def _rel_rows(x, v, addr: SlotAddr) -> torch.Tensor:
    """bf16 feature rows (precision="bf16"): positions relative to the
    center of the cell the ADDR binned the particle into, velocities
    absolute, both rounded to bf16 (RTNE, as the reference's astype).
    The build-time frame, because under reuse the slot's lane still
    encodes that cell after the particle drifts across a cell edge."""
    return _pack_rows6(x - addr.center, v).to(torch.bfloat16)


def _init_row(dtype, device) -> torch.Tensor:
    """Empty-slot feature row: far-away dummy position, zeros elsewhere."""
    return device_const((1e18, 1e18, 1e18, 0, 0, 0, 0, 0), dtype, device)


def stage_rows(addr: SlotAddr, rows: torch.Tensor, sg: SlotGrid):
    """The feature-minor staging array [c_rows·lanes, FEAT] of
    `scatter_slots(staged=True)`: each particle's row, padded to FEAT
    columns with zeros, at its slot; the empty-slot row elsewhere."""
    n, ncols = rows.shape
    if ncols < FEAT:
        rows = torch.cat([rows, rows.new_zeros((n, FEAT - ncols))], dim=1)
    size = sg.c_rows * sg.lanes
    base = torch.where(
        addr.ok(), addr.row_pos.long() * sg.lanes + addr.pos.long(), size)
    stag = _init_row(rows.dtype, rows.device).repeat(size + 1, 1)
    stag.index_put_((base,), rows)     # row `size`: the dump of the slotless
    return stag[:size]


def scatter_slots(addr: SlotAddr, rows: torch.Tensor, sg: SlotGrid,
                  staged: bool = False):
    """Scatter packed [N, ncols] rows → feat [c_rows, FEAT, lanes] of the
    rows' dtype (fp32, or bf16 rows from `_rel_rows`); empty slots hold the
    far-away row (1e18, 1e18, 1e18, 0, ...), in bf16 ≈9.98e17, still above
    the kernels' 1e17 empty test.

    staged=True: pad the rows to FEAT columns, scatter each particle's row
    into a feature-minor staging array [c_rows·lanes, FEAT] (its features
    contiguous, one row write per particle; particles without a slot go to
    a spare dump row), then transpose it to the kernel layout with K5
    (`stage_kernels`).  Bitwise the direct scatter's result."""
    with span("sph.scatter"):
        if staged:
            return stage_kernels.stage_transpose(
                stage_rows(addr, rows, sg), sg.c_rows, sg.lanes)
        size = sg.c_rows * FEAT * sg.lanes
        flat = torch.empty(size + 1, dtype=rows.dtype, device=rows.device)
        feat = flat[:size].view(sg.c_rows, FEAT, sg.lanes)
        feat[:, :3] = 1e18
        feat[:, 3:] = 0.0
        idx = _flat_slot_idx(addr, sg, rows.shape[1], size)
        flat.index_put_((idx.reshape(-1),), rows.reshape(-1))
        return feat


def pack2bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two fp32 arrays → one fp32-typed array whose bits are
    bf16(a) << 16 | bf16(b), RTNE.  Transport only: the value means
    nothing.  Built by views (the low half first in memory), no shifts."""
    halves = torch.stack([b.to(torch.bfloat16), a.to(torch.bfloat16)], dim=-1)
    return halves.view(torch.float32).squeeze(-1)


def unpack2bf16(p: torch.Tensor):
    """Inverse of pack2bf16: packed fp32 → (a, b) fp32 (bf16-valued)."""
    halves = p.contiguous().unsqueeze(-1).view(torch.bfloat16)
    return halves[..., 1].float(), halves[..., 0].float()


def scatter_slots_packed(addr: SlotAddr, rows: torch.Tensor, sg: SlotGrid,
                         bg_row: torch.Tensor) -> torch.Tensor:
    """scatter_slots for a non-feat column layout: [N, ncols] rows →
    [c_rows, ncols, lanes], empty slots filled with `bg_row` ([ncols]) —
    the packed-bf16 rebuild transport of the resident advance.  The bits
    move as int32, so a packed value is never read as a float on the way."""
    with span("sph.scatter"):
        ncols = rows.shape[1]
        bits = rows.view(torch.int32)
        size = sg.c_rows * ncols * sg.lanes
        base = addr.row_pos.long() * (ncols * sg.lanes) + addr.pos.long()
        idx = torch.where(
            addr.ok()[:, None],
            base[:, None] + torch.arange(ncols, device=rows.device) * sg.lanes,
            size)
        flat = bg_row.view(torch.int32)[:, None].expand(
            ncols, sg.lanes).repeat(sg.c_rows, 1).reshape(-1)
        flat = torch.cat([flat, flat.new_zeros(1)])  # the slotless' dump
        flat.index_put_((idx.reshape(-1),), bits.reshape(-1))
        return flat[:size].view(torch.float32).view(sg.c_rows, ncols, sg.lanes)


def slot_overflow(x, active, grid: GridSpec, sg: SlotGrid, ci_offset=None):
    """(cell overflow count, row overflow count): >0 ⇒ static caps dropped
    work this step."""
    addr = build_addr(x, active, grid, sg, ci_offset)
    _, flat = cell_index(x, active, grid, ci_offset)
    cell_over = torch.sum((~addr.valid) & (flat < grid.n_cells), dtype=torch.int32)
    row_over = torch.sum(addr.valid & (addr.row_pos == 0), dtype=torch.int32)
    return cell_over, row_over


# ---------------------------------------------------------------------------
# Kernel dispatch (K1, K2; K3, K4 for packed rows)
# ---------------------------------------------------------------------------


def _jblocks(addr: SlotAddr, sg: SlotGrid) -> torch.Tensor:
    """[c_rows] i32 occupied-128-block count per compacted row (a prefix
    count: packed lanes fill contiguously), so the packed kernels visit
    only the occupied blocks of a neighbor row."""
    return torch.sum(addr.gcounts[:, 0, :] > 0, dim=-1, dtype=torch.int32)


def _call_density(feat, addr: SlotAddr, sg: SlotGrid, params: SimParams,
                  jb=None):
    """→ rp_slot [c_rows, 2, lanes] lane-major (rho, EOS p).  `jb` is the
    packed layout's `_jblocks(addr, sg)`, when the caller already has it."""
    if sg.packed:
        if jb is None:
            jb = _jblocks(addr, sg)
        return packed_kernels.packed_density(
            feat, addr.n_occ, addr.nbr_pos, jb, addr.gcounts, params
        )
    return slot_kernels.slot_density(
        feat, addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params,
        sg.xsub, sg.cell,
    )


def _call_force(feat, rp, addr: SlotAddr, sg: SlotGrid, params: SimParams,
                jb=None):
    """→ f_slot [c_rows, FOUT, lanes] lane-major (components >= D zero)."""
    if sg.packed:
        if jb is None:
            jb = _jblocks(addr, sg)
        return packed_kernels.packed_force(
            feat, rp, addr.n_occ, addr.nbr_pos, jb, addr.gcounts, params
        )
    return slot_kernels.slot_force(
        feat, rp, addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params,
        sg.xsub, sg.cell,
    )


# ---------------------------------------------------------------------------
# Per-particle extraction (element-gathers from the lane-major slot arrays)
# ---------------------------------------------------------------------------


def slot_rows_view(slot: torch.Tensor) -> torch.Tensor:
    """[c_rows, C, lanes] → [c_rows·lanes, C] feature-minor copy (one dense
    transpose): a particle's C components become contiguous, so a
    per-particle read is one row gather instead of C strided element
    gathers."""
    return slot.transpose(1, 2).reshape(-1, slot.shape[1])


def _gather_rho(rp_slot, addr: SlotAddr, sg: SlotGrid, params: SimParams):
    with span("sph.gather"):
        ok = addr.ok()
        flat = addr.row_pos.long() * (2 * sg.lanes) + addr.pos.long()
        rho = rp_slot.reshape(-1)[torch.where(ok, flat, 0)]
        return torch.where(ok, rho, params.rest_density), ok


def _gather_f(f_slot, addr: SlotAddr, sg: SlotGrid, d: int, ok):
    with span("sph.gather"):
        base = addr.row_pos.long() * (FOUT * sg.lanes) + addr.pos.long()
        base = torch.where(ok, base, 0)
        cols = torch.arange(d, device=base.device) * sg.lanes
        f = f_slot.reshape(-1)[base[:, None] + cols[None, :]]
        return torch.where(ok[:, None], f, 0.0)


# ---------------------------------------------------------------------------
# Full pass: density → EOS → forces
# ---------------------------------------------------------------------------


def pallas_rho_p_f(
    x: torch.Tensor,
    v: torch.Tensor,
    active: torch.Tensor,
    params: SimParams,
    grid: GridSpec,
    c_rows: int | None = None,
    addr: SlotAddr | None = None,
    packed_rows: bool = False,
    row_lanes: int | None = None,
    row_pair: bool = False,
):
    """Per-particle (rho, p, f) through the slot kernels.

    `addr` (a SlotAddr from build_addr) reuses a neighbor structure built at
    an earlier step — valid while every particle has moved < skin/2 since it
    was built (GridSpec.for_scene skin; step.make_advance sort_every); under
    `precision="bf16"` it must carry its `center`.  `packed_rows` selects
    the packed-row layout (the addr must then come from a packed build
    too); `row_pair` pads c_rows even (`slot_grid`)."""
    d = x.shape[1]
    bf16 = params.precision == "bf16"
    if packed_rows:
        if bf16:
            raise ValueError("packed rows do not compose with bf16 features")
        sg = packed_grid(grid, row_lanes, c_rows)
    else:
        sg = slot_grid(grid, c_rows, row_pair=row_pair)
    if addr is None:
        addr = build_addr(x, active, grid, sg)
    rows = _rel_rows(x, v, addr) if bf16 else _pack_rows6(x, v)
    feat = scatter_slots(addr, rows, sg)
    jb = _jblocks(addr, sg) if sg.packed else None   # once for K3 and K4
    rp_slot = _call_density(feat, addr, sg, params, jb)
    f_slot = _call_force(feat, rp_slot, addr, sg, params, jb)
    rho, ok = _gather_rho(rp_slot, addr, sg, params)
    p = physics.eos_pressure(rho, params)
    f = _gather_f(f_slot, addr, sg, d, ok)
    return rho, p, f


# ---------------------------------------------------------------------------
# Split phases: density, then forces with external rho/p (decomp.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SplitCtx:
    """One addressing and one feature scatter shared by the split density
    and force phases of the halo-exchange step (`decomp.py`): positions do
    not move between them, only the ghosts' rho/p are re-imported."""

    sg: SlotGrid
    addr: SlotAddr
    feat: torch.Tensor


def pallas_split_build(x, v, active, params: SimParams, grid: GridSpec,
                       ci_offset=None) -> SplitCtx:
    """The shared SplitCtx on `grid`, shifted by `ci_offset` on a
    slab-local lattice (`neighbors.cell_index`)."""
    sg = slot_grid(grid)
    addr = build_addr(x, active, grid, sg, ci_offset)
    rows = (_rel_rows(x, v, addr) if params.precision == "bf16"
            else _pack_rows6(x, v))
    return SplitCtx(sg=sg, addr=addr, feat=scatter_slots(addr, rows, sg))


def pallas_density_split(ctx: SplitCtx, params: SimParams):
    """K1 over a prebuilt SplitCtx → per-particle rho."""
    rp_slot = _call_density(ctx.feat, ctx.addr, ctx.sg, params)
    return _gather_rho(rp_slot, ctx.addr, ctx.sg, params)[0]


def pallas_forces_split(ctx: SplitCtx, rho, p, params: SimParams, d: int):
    """K2 over a prebuilt SplitCtx with external per-particle rho/p (the
    ghosts' from their owners, through `scatter_rp`) → per-particle f."""
    rp = scatter_rp(ctx.addr, rho, p, ctx.sg)
    f_slot = _call_force(ctx.feat, rp, ctx.addr, ctx.sg, params)
    return _gather_f(f_slot, ctx.addr, ctx.sg, d, ctx.addr.ok())


def pallas_density(x, active, params: SimParams, grid: GridSpec,
                   ci_offset=None):
    """Density-only phase (mirrors `neighbors.grid_density`)."""
    ctx = pallas_split_build(x, torch.zeros_like(x), active, params, grid,
                             ci_offset)
    return pallas_density_split(ctx, params)


def scatter_rp(addr: SlotAddr, rho, p, sg: SlotGrid) -> torch.Tensor:
    """External per-particle rho/p → the [c_rows, 2, lanes] rp layout K2
    streams, zeros in empty slots.  Particles without a slot write to one
    spare element past the end (the reference's dropped writes)."""
    size = sg.c_rows * 2 * sg.lanes
    base = torch.where(addr.ok(),
                       addr.row_pos.long() * (2 * sg.lanes) + addr.pos.long(),
                       size)
    idx = torch.stack([base, torch.where(base < size, base + sg.lanes, size)],
                      dim=1)
    flat = torch.zeros(size + 1, dtype=rho.dtype, device=rho.device)
    flat.index_put_((idx.reshape(-1),),
                    torch.stack([rho, p], dim=1).reshape(-1))
    return flat[:size].view(sg.c_rows, 2, sg.lanes)


def pallas_forces(x, v, rho, p, active, params: SimParams, grid: GridSpec,
                  ci_offset=None):
    """Force-only phase given rho/p (mirrors `neighbors.grid_forces`)."""
    ctx = pallas_split_build(x, v, active, params, grid, ci_offset)
    return pallas_forces_split(ctx, rho, p, params, x.shape[1])
