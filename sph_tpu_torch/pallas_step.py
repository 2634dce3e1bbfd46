"""The slot-layout density + force pass (port of the per-step path of
`sph_tpu/pallas_step.py`).

Layout, kept from the reference so per-particle results compare one to one:

  1. Row compaction: only occupied (z, y) cell rows exist in memory, at
     compacted positions 1..n_occ.  Position 0 is a reserved always-empty
     DUMMY row (positions 1e18, rho 0).  Every neighbor-row lookup that
     misses (row unoccupied, outside the grid, or dropped by the c_rows cap)
     routes to row 0, whose features annihilate every pair term, so the
     kernels need no validity masks.
  2. One scatter packs per-particle features [x | v] into
     feat[c_rows, FEAT, lanes]: feature axis in the middle, (x-cell · cap)
     on the lanes, with a one-group (128-lane) x halo on each side so every
     ±1-cell candidate window is in bounds.
  3. The density kernel (K1) reads the 3^(D-1) neighbor rows of each row
     through the int32 table `nbr_pos[R, c_rows]`, sums poly6 over the ±1
     x-cells, applies the EOS, and writes lane-major (rho, p) rows
     rp[c_rows, 2, lanes].  The force kernel (K2) streams the same rows of
     feat and rp and writes f[c_rows, FOUT, lanes].  Both are hand-written
     CUDA (`slot_kernels.py`, `csrc/slot_kernels.cu`); on CPU tensors they
     run their plain PyTorch versions.
  4. Per-particle values are element-gathered back from the slot arrays.

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

from sph_tpu_torch import physics, slot_kernels
from sph_tpu_torch.neighbors import GridSpec, cell_index
from sph_tpu_torch.params import SimParams
from sph_tpu_torch.platform import device_const
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
    cap: int                 # slot-cell capacity; must divide 128
    c_rows: int              # compacted-row capacity incl. dummy row 0

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
    def h2(self) -> int:     # x cells per row incl. one-group halos
        return _round_up(self.inner[-1], self.xc) + 2 * self.xc

    @property
    def n_groups(self) -> int:
        return self.h2 // self.xc

    @property
    def lanes(self) -> int:
        return self.h2 * self.cap

    @property
    def row_offsets(self) -> tuple[tuple[int, int], ...]:
        if self.dim == 2:
            return tuple((0, dy) for dy in (-1, 0, 1))
        return tuple((dz, dy) for dz in (-1, 0, 1) for dy in (-1, 0, 1))


def slot_grid(grid: GridSpec, c_rows: int | None = None) -> SlotGrid:
    if grid.xsub != 1:
        raise NotImplementedError(
            "xsub > 1 is not ported yet (ROADMAP.md Queue 1 item 15)"
        )
    if LANE % grid.cap != 0:
        raise ValueError(f"the slot path needs cap | 128, got {grid.cap}")
    dim = len(grid.shape)
    inner_rows = (grid.shape[0] + 2 if dim == 3 else 1) * (grid.shape[-2] + 2)
    if c_rows is None:
        # always-correct when the row space is small; else a documented cap
        c_rows = inner_rows if inner_rows <= 4096 else 4096
    c_rows = min(c_rows, inner_rows) + 1  # +1: reserved dummy row 0
    return SlotGrid(inner=grid.shape, cap=grid.cap, c_rows=c_rows)


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
    """Per-particle slot addressing + row compaction, built once per step.
    Every field is equal, element for element, to the reference's
    (`sph_tpu.pallas_step.SlotAddr`; its `center` field serves only the
    bf16 features, which are not ported)."""

    pos: torch.Tensor        # [N] i32 lane position hx·cap + rank
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

    def ok(self) -> torch.Tensor:
        """[N] bool — the particle has a slot (in a cell, within both caps)."""
        return self.valid & (self.row_pos > 0)


def build_addr(x: torch.Tensor, active: torch.Tensor, grid: GridSpec,
               sg: SlotGrid) -> SlotAddr:
    n = x.shape[0]
    dev = x.device
    i32 = torch.int32
    ci, flat = cell_index(x, active, grid)
    in_cell = flat < grid.n_cells
    h0 = (ci[:, 0] + 1) if sg.dim == 3 else torch.zeros(n, dtype=i32, device=dev)
    h1 = ci[:, -2] + 1
    hx = ci[:, -1] + sg.xc                     # one-group x halo
    n_hrows = sg.h0 * sg.h1 * sg.h2
    hrow = (h0 * sg.h1 + h1) * sg.h2 + hx
    hrow = torch.where(in_cell, hrow, n_hrows)
    rank = cell_ranks(hrow, n_hrows + 1)
    valid = in_cell & (rank < sg.cap)
    pos = hx * sg.cap + rank
    gx = hx // sg.xc

    code = h0 * sg.h1 + h1                     # (z, y) row code, interior
    n_codes = sg.h0 * sg.h1
    row_occ = torch.zeros(n_codes + 1, dtype=i32, device=dev)
    row_occ.index_add_(
        0, torch.where(valid, code, n_codes).long(),
        torch.ones(n, dtype=i32, device=dev),
    )
    row_occ = row_occ[:n_codes] > 0
    usable = sg.c_rows - 1                     # row 0 is the dummy
    n_occ = torch.clamp(torch.sum(row_occ, dtype=i32), max=usable).reshape(1)
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
        torch.where(in_range, 1 + torch.arange(usable, dtype=i32, device=dev),
                    0),
    )
    row_pos = row_inv[code.long()]             # 0 iff dropped by c_rows cap
    ok = valid & (row_pos > 0)
    overflow = (
        torch.sum((~valid) & in_cell, dtype=i32)
        + torch.sum(valid & (row_pos == 0), dtype=i32)
    )

    gcounts = torch.zeros(sg.c_rows * sg.n_groups, dtype=i32, device=dev)
    gcounts.index_add_(
        0, torch.where(ok, row_pos * sg.n_groups + gx, 0).long(), ok.to(i32)
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
    offs = device_const(tuple(dz * sg.h1 + dy for dz, dy in sg.row_offsets),
                        i32, dev)
    nbr_idx = torch.clamp(codes_ext[None, :] + offs[:, None], 0, n_codes)
    nbr_pos = row_inv[nbr_idx.long()]
    # the dummy row's own neighbors stay the dummy row
    nbr_pos[:, 0] = 0
    return SlotAddr(
        pos=pos, valid=valid, row_pos=row_pos, gcounts=gcounts,
        n_occ=n_occ, nbr_pos=nbr_pos.contiguous(), overflow=overflow,
        row_code=codes_ext,
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


def scatter_slots(addr: SlotAddr, rows: torch.Tensor, sg: SlotGrid):
    """Scatter packed [N, ncols] rows → feat [c_rows, FEAT, lanes]; empty
    slots hold the far-away row (1e18, 1e18, 1e18, 0, ...)."""
    size = sg.c_rows * FEAT * sg.lanes
    flat = torch.empty(size + 1, dtype=rows.dtype, device=rows.device)
    feat = flat[:size].view(sg.c_rows, FEAT, sg.lanes)
    feat[:, :3] = 1e18
    feat[:, 3:] = 0.0
    idx = _flat_slot_idx(addr, sg, rows.shape[1], size)
    flat.index_put_((idx.reshape(-1),), rows.reshape(-1))
    return feat


def slot_overflow(x, active, grid: GridSpec, sg: SlotGrid):
    """(cell overflow count, row overflow count): >0 ⇒ static caps dropped
    work this step."""
    addr = build_addr(x, active, grid, sg)
    _, flat = cell_index(x, active, grid)
    cell_over = torch.sum((~addr.valid) & (flat < grid.n_cells), dtype=torch.int32)
    row_over = torch.sum(addr.valid & (addr.row_pos == 0), dtype=torch.int32)
    return cell_over, row_over


# ---------------------------------------------------------------------------
# Kernel dispatch (K1, K2)
# ---------------------------------------------------------------------------


def _call_density(feat, addr: SlotAddr, sg: SlotGrid, params: SimParams):
    """→ rp_slot [c_rows, 2, lanes] lane-major (rho, EOS p)."""
    return slot_kernels.slot_density(
        feat, addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params
    )


def _call_force(feat, rp, addr: SlotAddr, sg: SlotGrid, params: SimParams):
    """→ f_slot [c_rows, FOUT, lanes] lane-major (components >= D zero)."""
    return slot_kernels.slot_force(
        feat, rp, addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params
    )


# ---------------------------------------------------------------------------
# Per-particle extraction (element-gathers from the lane-major slot arrays)
# ---------------------------------------------------------------------------


def _gather_rho(rp_slot, addr: SlotAddr, sg: SlotGrid, params: SimParams):
    ok = addr.ok()
    flat = addr.row_pos.long() * (2 * sg.lanes) + addr.pos.long()
    rho = rp_slot.reshape(-1)[torch.where(ok, flat, 0)]
    return torch.where(ok, rho, params.rest_density), ok


def _gather_f(f_slot, addr: SlotAddr, sg: SlotGrid, d: int, ok):
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
):
    """Per-particle (rho, p, f) through the slot kernels."""
    d = x.shape[1]
    sg = slot_grid(grid, c_rows)
    addr = build_addr(x, active, grid, sg)
    feat = scatter_slots(addr, _pack_rows6(x, v), sg)
    rp_slot = _call_density(feat, addr, sg, params)
    f_slot = _call_force(feat, rp_slot, addr, sg, params)
    rho, ok = _gather_rho(rp_slot, addr, sg, params)
    p = physics.eos_pressure(rho, params)
    f = _gather_f(f_slot, addr, sg, d, ok)
    return rho, p, f
