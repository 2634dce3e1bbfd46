"""Cell-grid geometry and per-particle cell indices (port of the parts of
`sph_tpu/neighbors.py` that the slot path needs).

The cell size is h, so every pair with r < h lies within ±1 cell on each
axis.  The XLA grid method itself
(`build_tiles`, `grid_rho_p_f`) is not ported yet (ROADMAP.md Queue 1
item 6).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from sph_tpu_torch.params import Scene
from sph_tpu_torch.platform import device_const


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (hashable)."""

    lo: tuple[float, ...]     # grid origin (scene lo minus one-cell margin)
    cell: float               # cell edge length == support radius h
    shape: tuple[int, ...]    # cells per axis
    cap: int                  # max particles per cell
    xsub: int = 1             # x-cell subdivision of the slot layout; the
    #                           port supports 1 only (ROADMAP Queue 1 item 15)

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def n_cells(self) -> int:
        return math.prod(self.shape)

    @property
    def dump_row(self) -> int:
        # the reference keeps an always-empty row at n_cells; inactives go
        # to the row after it
        return self.n_cells + 1

    @staticmethod
    def for_scene(scene: Scene, cap: int | None = None,
                  xsub: int = 1) -> "GridSpec":
        """Cells of edge h over the scene box plus a one-cell margin.  The
        Verlet-skin widening of the reference (`skin`) comes with
        `sort_every` (ROADMAP.md Queue 1 item 8)."""
        p = scene.params
        cell = float(p.h)
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


def cell_index(x: torch.Tensor, active: torch.Tensor, grid: GridSpec):
    """Per-particle (multi-index [N, D] i32, flat row id [N] i32).

    Out-of-domain actives clip to edge cells (clipping only shrinks
    cell-space distance, so the ±1 window stays a superset); inactives go
    to the dump row.

    Binning is bitwise the reference's: fp32 `floor((x − lo) / cell)` with a
    true IEEE division.  The divisor is a 0-d tensor on x's device because
    PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
    which can move a particle on a cell edge into the next cell.
    """
    lo = device_const(grid.lo, x.dtype, x.device)
    cell = device_const(grid.cell, x.dtype, x.device)
    ci = torch.floor((x - lo) / cell).to(torch.int32)
    hi = device_const(tuple(s - 1 for s in grid.shape), torch.int32, x.device)
    ci = torch.minimum(torch.clamp(ci, min=0), hi)
    # ravel, last axis fastest (so ±1 in the last axis is contiguous in rows)
    flat = ci[:, 0]
    for a in range(1, grid.dim):
        flat = flat * grid.shape[a] + ci[:, a]
    flat = torch.where(active, flat, grid.dump_row)
    return ci, flat.to(torch.int32)
