"""Cell-grid geometry, per-particle cell indices, and the grid method
(port of `sph_tpu/neighbors.py`).

The cell size is h (+ a Verlet skin under address reuse), so every pair
with r < h lies within ±1 cell on each axis.

The grid method (`method="grid"`) is plain PyTorch, as the reference's is
XLA with no Pallas kernel:

  1. cell id per particle (`cell_index`); inactives go to the dump row;
  2. a stable sort by cell id fills fixed-size per-cell tiles
     (`build_tiles`), each listing its particles in ascending index order,
     padded with the sentinel index N (a dummy particle far away);
  3. each particle gathers the tiles of its 3^D adjacent cells
     (`_neighbor_rows`) and sums over those candidates, in particle chunks
     whose candidate gathers fit `GATHER_BUDGET` bytes.

A particle past a cell's cap falls out of its tile (`cell_overflow`
reports by how much), as in the reference.

Domain decomposition (`decomp.py`) runs on a rank-local lattice: fewer
cells along the slab axis (`GridSpec.for_slab`) or along both pencil axes
(`GridSpec.for_pencil`), indices computed against the global lattice and
shifted by a whole number of cells per rank (`ci_offset`).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch

from sph_tpu_torch import physics
from sph_tpu_torch.params import Scene, SimParams
from sph_tpu_torch.platform import device_const


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (hashable)."""

    lo: tuple[float, ...]     # grid origin (scene lo minus one-cell margin)
    cell: float               # cell edge length: support radius h + skin
    shape: tuple[int, ...]    # cells per axis
    cap: int                  # max particles per cell
    xsub: int = 1             # x-cell subdivision of the slot layout
    #                           (slot-cells of cap/xsub, `pallas_step`)

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def n_cells(self) -> int:
        return math.prod(self.shape)

    @property
    def n_rows(self) -> int:
        # + always-empty row (invalid-neighbor target) + inactive dump row
        return self.n_cells + 2

    @property
    def empty_row(self) -> int:
        return self.n_cells

    @property
    def dump_row(self) -> int:
        return self.n_cells + 1

    @property
    def n_offsets(self) -> int:
        return 3**self.dim

    @staticmethod
    def for_scene(scene: Scene, cap: int | None = None, skin: float = 0.0,
                  xsub: int = 1) -> "GridSpec":
        """Cells of edge h + skin over the scene box plus a one-cell margin.

        `skin` > 0 widens the cells (pseudo-Verlet): a neighbor structure
        built from positions at time t0 stays a correct superset of all
        r < h pairs while every particle has moved less than skin/2 since
        t0 — the basis of `sort_every` address reuse (`step.make_advance`).
        Compact support keeps results exact regardless of cell size."""
        p = scene.params
        cell = float(p.h) + float(skin)
        spacing = scene.spacing or p.h * 0.55
        lo = tuple(float(l) - cell for l in scene.lo)
        hi = tuple(float(h) + cell for h in scene.hi)
        shape = tuple(
            max(1, int(math.ceil((h - l) / cell))) for l, h in zip(lo, hi)
        )
        if cap is None:
            cap = scene.grid_cap or None
        if cap is None:
            # rest occupancy (cell/spacing)^dim, ×2.5 compression headroom
            cap = _round_up(int(math.ceil((cell / spacing) ** p.dim * 2.5)), 8)
        cap = _round_up(cap, xsub)
        return GridSpec(lo=lo, cell=cell, shape=shape, cap=cap, xsub=xsub)

    @staticmethod
    def for_slab(scene: Scene, slab_w: float, axis: int,
                 cap: int | None = None, skin: float = 0.0) -> "GridSpec":
        """Slab-local grid of the spatial decomposition: along `axis` it
        spans one slab plus an (h + skin)-deep ghost band and margin cells,
        so a rank's grid and slot memory scale 1/n_shards.  `lo` stays the
        global origin; each rank shifts its cell indices by an integer
        `ci_offset` (`cell_index`)."""
        full = GridSpec.for_scene(scene, cap=cap, skin=skin)
        h_eff = scene.params.h + skin
        # cells covering [my_lo − h_eff − 2·cell, my_hi + h_eff + cell] for
        # any alignment of the slab against the lattice
        n_ax = int(math.ceil((slab_w + 2 * h_eff) / full.cell)) + 3
        shape = tuple(min(n_ax, s) if a == axis else s
                      for a, s in enumerate(full.shape))
        return GridSpec(lo=full.lo, cell=full.cell, shape=shape,
                        cap=full.cap, xsub=full.xsub)

    @staticmethod
    def for_pencil(scene: Scene, widths: dict, cap: int | None = None,
                   skin: float = 0.0) -> "GridSpec":
        """Pencil-local grid: `for_slab`'s restriction along every axis of
        `widths` ({axis: pencil width}), so a rank's grid and slot memory
        scale 1/(n1·n2).  The same global `lo` and integer `ci_offset`."""
        full = GridSpec.for_scene(scene, cap=cap, skin=skin)
        h_eff = scene.params.h + skin
        shape = tuple(
            min(int(math.ceil((widths[a] + 2 * h_eff) / full.cell)) + 3, s)
            if a in widths else s
            for a, s in enumerate(full.shape))
        return GridSpec(lo=full.lo, cell=full.cell, shape=shape,
                        cap=full.cap, xsub=full.xsub)


def cell_index(x: torch.Tensor, active: torch.Tensor, grid: GridSpec,
               ci_offset: tuple[int, ...] | None = None):
    """Per-particle (multi-index [N, D] i32, flat row id [N] i32).

    Out-of-domain actives clip to edge cells (clipping only shrinks
    cell-space distance, so the ±1 window stays a superset); inactives go
    to the dump row.  `ci_offset` (D ints) shifts the index origin by whole
    cells for a slab-local grid (`GridSpec.for_slab`): an integer
    subtraction, so the pair arithmetic does not depend on the
    decomposition.

    Binning is bitwise the reference's: fp32 `floor((x − lo) / cell)` with a
    true IEEE division.  The divisor is a 0-d tensor on x's device because
    PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
    which can move a particle on a cell edge into the next cell.
    """
    lo = device_const(grid.lo, x.dtype, x.device)
    cell = device_const(grid.cell, x.dtype, x.device)
    ci = torch.floor((x - lo) / cell).to(torch.int32)
    if ci_offset is not None:
        ci = ci - device_const(tuple(ci_offset), torch.int32, x.device)
    hi = device_const(tuple(s - 1 for s in grid.shape), torch.int32, x.device)
    ci = torch.minimum(torch.clamp(ci, min=0), hi)
    # ravel, last axis fastest (so ±1 in the last axis is contiguous in rows)
    flat = ci[:, 0]
    for a in range(1, grid.dim):
        flat = flat * grid.shape[a] + ci[:, a]
    flat = torch.where(active, flat, grid.dump_row)
    return ci, flat.to(torch.int32)


def build_tiles(flat: torch.Tensor, grid: GridSpec):
    """Counting sort by cell → (tile [n_rows, cap] i32, order, starts,
    counts).

    tile[c] lists the particle indices in cell c in ascending original-index
    order (stable sort), padded with the sentinel N; a rank past the cap is
    dropped (static-cap overflow)."""
    n = flat.shape[0]
    dev = flat.device
    flat = flat.long()
    order = torch.argsort(flat, stable=True)
    sorted_flat = flat[order]
    counts = torch.bincount(flat, minlength=grid.n_rows)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[sorted_flat]
    tile = torch.full((grid.n_rows * grid.cap + 1,), n, dtype=torch.int32,
                      device=dev)
    # dropped ranks write into one spare element past the end
    dest = torch.where(rank < grid.cap, sorted_flat * grid.cap + rank,
                       grid.n_rows * grid.cap)
    tile[dest] = order.to(torch.int32)
    tile = tile[:-1].reshape(grid.n_rows, grid.cap)
    return tile, order, starts, counts


def cell_overflow(x, active, grid: GridSpec) -> torch.Tensor:
    """Max particles in any real cell minus cap (>0 ⇒ tile overflow)."""
    _, flat = cell_index(x, active, grid)
    counts = torch.bincount(flat.long(), minlength=grid.n_rows)
    return torch.max(counts[: grid.n_cells]) - grid.cap


def _neighbor_rows(ci: torch.Tensor, grid: GridSpec) -> torch.Tensor:
    """For each particle's cell multi-index [C, D], the 3^D adjacent flat
    row ids [C, 3^D] (offsets in the reference's order); out-of-grid
    neighbors point at the always-empty row."""
    shape = device_const(grid.shape, torch.int32, ci.device)
    rows = []
    for off in itertools.product((-1, 0, 1), repeat=grid.dim):
        idx = ci + device_const(off, torch.int32, ci.device)[None, :]
        valid = torch.all((idx >= 0) & (idx < shape[None, :]), dim=-1)
        idxc = torch.minimum(torch.clamp(idx, min=0), shape[None, :] - 1)
        flat = idxc[:, 0]
        for a in range(1, grid.dim):
            flat = flat * grid.shape[a] + idxc[:, a]
        rows.append(torch.where(valid, flat, grid.empty_row))
    return torch.stack(rows, dim=1)


# ---------------------------------------------------------------------------
# Density + EOS + forces over the grid
# ---------------------------------------------------------------------------

#: Bytes the candidate gathers of one particle chunk may take: the force
#: pass gathers [chunk, 3^D·cap, 2D + 2] floats.  The chunks change no
#: neighbor set and no order of a sum, only how many particles go at once.
GATHER_BUDGET = 1 << 30


def _spans(n: int, grid: GridSpec, d: int) -> list[tuple[int, int]]:
    """Particle ranges [a, b) whose force gathers fit GATHER_BUDGET."""
    per = grid.n_offsets * grid.cap * (2 * d + 2) * 4
    step = max(1, GATHER_BUDGET // per)
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def _candidates(ci, tile, grid: GridSpec) -> torch.Tensor:
    """[C, 3^D·cap] candidate particle indices (N = none) of cells `ci`."""
    rows = _neighbor_rows(ci, grid)
    return tile[rows.long()].reshape(ci.shape[0], -1).long()


def _density_block(xc, idx, x_pad, n, params: SimParams):
    xj = x_pad[idx]                                   # [C, K, D]
    dx = xc[:, None, :] - xj
    r2 = torch.sum(dx * dx, dim=-1)
    mask = (idx < n).to(xc.dtype)
    return torch.sum(physics.density_contrib(r2, mask, params), dim=-1)


def _force_block(xc, vc, pc, idx, feat_pad, n, d, params: SimParams):
    """One gather of packed [x | v | rho | p] rows per candidate."""
    fj = feat_pad[idx]                                # [C, K, 2D+2]
    dx = xc[:, None, :] - fj[..., :d]
    r2 = torch.sum(dx * dx, dim=-1)
    mask = (idx < n).to(xc.dtype)
    return torch.sum(
        physics.force_contrib(
            dx, r2, vc[:, None, :], fj[..., d : 2 * d], pc[:, None],
            fj[..., 2 * d + 1], fj[..., 2 * d], mask, params,
        ),
        dim=-2,
    )


def _x_pad(x):
    """x with the far dummy particle at index N (W = 0 against anything)."""
    far = torch.full((1, x.shape[1]), 1e18, dtype=x.dtype, device=x.device)
    return torch.cat([x, far], dim=0)


def _feat_pad(x, v, rho, p):
    """[N+1, 2D+2] packed rows x | v | rho | p (dummy: far, 0, 1, 0)."""
    d = x.shape[1]
    feat = torch.cat([x, v, rho[:, None], p[:, None]], dim=1)
    dummy = torch.zeros((1, 2 * d + 2), dtype=x.dtype, device=x.device)
    dummy[0, :d] = 1e18
    dummy[0, 2 * d] = 1.0
    return torch.cat([feat, dummy], dim=0)


def _tiles(x, active, grid: GridSpec, ci_offset=None):
    ci, flat = cell_index(x, active, grid, ci_offset)
    return ci, build_tiles(flat, grid)[0]


def _density_pass(x, active, params, grid, ci, tile):
    n, d = x.shape
    x_pad = _x_pad(x)
    rho = torch.cat([
        _density_block(x[a:b], _candidates(ci[a:b], tile, grid), x_pad, n,
                       params)
        for a, b in _spans(n, grid, d)
    ])
    return torch.where(active, rho, params.rest_density)


def _force_pass(x, v, rho, p, active, params, grid, ci, tile):
    n, d = x.shape
    feat_pad = _feat_pad(x, v, rho, p)
    f = torch.cat([
        _force_block(x[a:b], v[a:b], p[a:b], _candidates(ci[a:b], tile, grid),
                     feat_pad, n, d, params)
        for a, b in _spans(n, grid, d)
    ])
    return f * active[:, None].to(x.dtype)


def grid_density(x, active, params: SimParams, grid: GridSpec,
                 ci_offset=None):
    """Density only (the split phase of the halo-exchange step, where ghost
    rho/p are re-imported between the passes — `decomp.py`)."""
    return _density_pass(x, active, params, grid,
                         *_tiles(x, active, grid, ci_offset))


def grid_forces(x, v, rho, p, active, params: SimParams, grid: GridSpec,
                ci_offset=None):
    """Pairwise forces given rho/p (split phase, see grid_density)."""
    return _force_pass(x, v, rho, p, active, params, grid,
                       *_tiles(x, active, grid, ci_offset))


def grid_rho_p_f(x, v, active, params: SimParams, grid: GridSpec):
    """Density → EOS → pairwise forces over the cell tiles, which are built
    once for both passes; matches the naive path up to fp reduction order
    (tests/test_torch_grid.py)."""
    ci, tile = _tiles(x, active, grid)
    rho = _density_pass(x, active, params, grid, ci, tile)
    p = physics.eos_pressure(rho, params)
    f = _force_pass(x, v, rho, p, active, params, grid, ci, tile)
    return rho, p, f
