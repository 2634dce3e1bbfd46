"""Carries for the minority repair's plan and apply (`sph_tpu_torch.repair`):
hand-placed particles that reach each branch of the plan, and a seeded
random cloud, on any device, on the single-device lattice or on a slab's
(`slab`: the lattice shifted by an index offset, and the slab's faces).

A hand-placed carry sits on a lattice of 10-unit cells, (row, x) in 2-D and
(1, row, x) in 3-D.  `residents` are (cell, count) of particles that stay
put, `movers` (from cell, to cell) of fast particles whose slot x moved into
the target cell, `extra` (cell, count) particles placed after the movers; a
cell's particles take its lanes in index order.  Counts below 1 are
relative to the cap (0 fills the cell).  Only the movers are risky.

This module imports numpy, torch and `sph_tpu_torch` only, so that the card
tests (`tests/test_torch_gpu.py`) use it too.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from sph_tpu_torch import decomp, neighbors
from sph_tpu_torch import pallas_step as ps
from sph_tpu_torch import step as port_step
from sph_tpu_torch.slot_pass import SlotBlock

CELL = 10.0

#: name -> (residents, movers, extra, repair_k, can)
PLACED = {
    # no risky particle: no repair
    "calm": ([((2, 3), 2), ((2, 2), 1)], [], [], 8, False),
    # three movers, from two other rows and the next x cell, into a cell
    # with one resident: they take its free lanes 1, 2, 3 in index order
    "several_into_one": ([((2, 3), 1), ((1, 3), 1), ((3, 3), 1),
                          ((2, 2), 1)],
                         [((1, 3), (2, 3)), ((3, 3), (2, 3)),
                          ((2, 2), (2, 3))], [], 8, True),
    # a full cell whose particle moves inside it: its own lane is the one
    # free lane once it left it
    "same_cell_rehome": ([((2, 3), -2), ((2, 2), 1)],
                         [((2, 3), (2, 3))], [((2, 3), 1)], 8, True),
    # two full cells swap one particle each: each mover lands in the lane
    # the other left
    "swap_full_cells": ([((2, 2), -1), ((2, 3), -1)],
                        [((2, 2), (2, 3)), ((2, 3), (2, 2))], [], 8, True),
    # a mover into a full cell: no free lane, no repair
    "no_free_lane": ([((2, 3), 0), ((2, 2), 1)],
                     [((2, 2), (2, 3))], [], 8, False),
    # three movers into a cell with two free lanes: the third is not placed
    "crowded": ([((2, 3), -2), ((1, 3), 3)],
                [((1, 3), (2, 3))] * 3, [], 8, False),
    # a mover into a row no particle occupies: its target row is the dummy
    # row 0, no repair
    "to_row_0": ([((2, 2), 2)], [((2, 2), (4, 2))], [], 8, False),
    # more movers than repair_k: no repair
    "over_repair_k": ([((2, 3), 1), ((1, 3), 1), ((3, 3), 1), ((2, 2), 1)],
                      [((1, 3), (2, 3)), ((3, 3), (2, 3)),
                       ((2, 2), (2, 3))], [], 2, False),
}


#: slab name -> (cells of the lattice's index offset along the slab axis,
#: the lower face's cells above the offset, the upper face's cells below
#: the lattice's end, first, last, band depth): the slab axis is the rows'
#: (axis dim - 2)
SLABS = {
    # interior faces whose bands hold no particle of rows 1 and up of a
    # hand-placed carry
    "interior": (3, 0.6, 0.5, False, False, 3.0),
    # the same faces, a band that holds row 1's anchors: a mover from row
    # 1 vetoes the repair
    "veto": (3, 0.6, 0.5, False, False, 6.0),
    # one slab between domain walls: no face, no band
    "walls": (3, 0.6, 0.5, True, True, 6.0),
}


def slab(dim: int, name: str, cells: int = 6):
    """(ci_off, `decomp._Slab`, band) of the slab `name` on a lattice of
    `cells` cells along the slab axis."""
    k, lo, hi, first, last, band = SLABS[name]
    ax = dim - 2
    ci_off = tuple(k if a == ax else 0 for a in range(dim))
    faces = decomp._Slab(axis=ax, first=first, last=last,
                         lo=float(np.float32((k + lo) * CELL)),
                         hi=float(np.float32((k + cells - hi) * CELL)),
                         ci_off=ci_off)
    return ci_off, faces, band


def clone(c, other):
    """Copies of a carry's slot arrays (x0s still its xs where it was) and
    of another storage, for an apply that patches them in place."""
    keys = ("xs", "vs", "acc", "x0s", "rp", "movb")
    c2 = {**c, **{k: c[k].clone() for k in keys}}
    if c["x0s"].data_ptr() == c["xs"].data_ptr():
        c2["x0s"] = c2["xs"]
    o2 = copy.copy(other)
    o2.feat, o2.acc = other.feat.clone(), other.acc.clone()
    return c2, o2


def lattice(dim: int, cap: int):
    shape = (6, 6) if dim == 2 else (4, 6, 6)
    grid = neighbors.GridSpec(lo=(0.0,) * dim, cell=CELL, shape=shape,
                              cap=cap)
    return grid, ps.slot_grid(grid)


def _finish(c, sg, dim, dev, seed):
    """The carry's acc and rp (random, so a move shows), and one other
    storage filled for its addressing, holding garbage."""
    rng = np.random.default_rng(seed)
    shape = (sg.c_rows, dim, sg.lanes)
    acc = torch.from_numpy(rng.normal(0.0, 50.0, shape).astype(np.float32))
    rp = torch.from_numpy(rng.uniform(0.5, 2.0, (sg.c_rows, 2, sg.lanes))
                          .astype(np.float32))
    c.update(acc=torch.where(c["movb"].cpu(), acc, 0.0).to(dev),
             rp=rp.to(dev))
    other = SlotBlock(sg.c_rows, sg.lanes, dim, False, dev)
    junk = rng.normal(0.0, 9.0, (sg.c_rows, 8, sg.lanes)).astype(np.float32)
    other.feat.copy_(torch.from_numpy(junk))
    other.acc.copy_(torch.from_numpy(junk[:, :dim]))
    other.addr = c["addr"]
    return other


def placed(dim: int, cap: int, name: str, dev="cpu", ci_off=None):
    """(grid, sg, carry, x0, movers' indices, other storage, repair_k,
    can) of the hand-placed carry `name`, its cells shifted by `ci_off`
    (the lattice's index offset) when given."""
    residents, movers, extra, repair_k, can = PLACED[name]
    grid, sg = lattice(dim, cap)
    off = ci_off or (0,) * dim

    def at(c, k):
        c = c if dim == 2 else (1, *c)
        return [(ci + o + 0.05 + 0.05 * k) * CELL for ci, o in zip(c, off)]

    count = {}

    def place(c):
        k = count.get(c, 0)
        count[c] = k + 1
        return at(c, k)

    def n_of(n):
        return n if n > 0 else cap + n

    x0 = [place(c) for c, n in residents for _ in range(n_of(n))]
    first = len(x0)
    x0 += [place(a) for a, _ in movers]
    x0 += [place(c) for c, n in extra for _ in range(n_of(n))]
    x1 = [at(b, 17) for _, b in movers]
    x0 = torch.tensor(x0, dtype=torch.float32, device=dev)
    n = x0.shape[0]
    act = torch.ones(n, dtype=torch.bool, device=dev)
    c = port_step._scatter_residency(x0, torch.zeros_like(x0), act, act,
                                     grid, sg, False, ci_off)
    addr = c["addr"]
    assert bool(addr.ok().all())
    mv = torch.arange(first, first + len(movers), device=dev)
    if len(movers):
        row, pos = addr.row_pos[mv].long(), addr.pos[mv].long()
        xs, vs = c["xs"].clone(), c["vs"].clone()
        xs[row, :, pos] = torch.tensor(x1, dtype=torch.float32, device=dev)
        vs[row, :, pos] = 100.0
        c.update(xs=xs, vs=vs)
    other = _finish(c, sg, dim, dev, seed=cap + dim)
    return grid, sg, c, x0, mv, other, repair_k, can


def cloud_side(dim: int, cap: int, n: int) -> int:
    """The cells along each axis of `cloud`'s lattice."""
    return max(4, int(round((4.0 * n / cap) ** (1.0 / dim))))


def cloud(dim: int, cap: int, n: int, seed: int, dev="cpu",
          alias_x0s: bool = False, share: float = 0.03, ci_off=None):
    """(grid, sg, carry, x0, act, movable, other storage) of a seeded random
    cloud, a quarter of the cap a cell: the carry's slots hold the cloud
    after a `share` of its particles moved by a few units (half of those
    fast), so that risky particles sit in many blocks of the plan's
    particle pass and many cells; a tenth is inactive and a tenth not
    movable.  `alias_x0s`: the carry's x0s is its xs, as on a carry fresh
    from a build.  `ci_off`: the lattice's index offset, the cloud shifted
    with it."""
    rng = np.random.default_rng(seed)
    side = cloud_side(dim, cap, n)
    grid = neighbors.GridSpec(lo=(0.0,) * dim, cell=CELL,
                              shape=(side,) * dim, cap=cap)
    sg = ps.slot_grid(grid)
    off = np.asarray(ci_off or (0,) * dim, np.float32) * CELL
    x0 = (rng.uniform(0.0, side * CELL, (n, dim)) + off).astype(np.float32)
    active = np.ones(n, bool)
    active[rng.choice(n, n // 10, replace=False)] = False
    movable = active.copy()
    movable[rng.choice(n, n // 10, replace=False)] = False
    moved = rng.uniform(0.0, 1.0, n) < share
    x1 = np.where(moved[:, None],
                  x0 + rng.normal(0.0, 2.0, (n, dim)), x0).astype(np.float32)
    v = rng.normal(0.0, 1.0, (n, dim))
    v = np.where((moved & (rng.uniform(0.0, 1.0, n) < 0.5))[:, None],
                 200.0 * v, v).astype(np.float32)
    x0t, x1t, vt, at, mt = (torch.from_numpy(a).to(dev)
                            for a in (x0, x1, v, active, movable))
    c = port_step._scatter_residency(x0t, vt, at, mt, grid, sg, False,
                                     ci_off)
    # the same addressing, the moved positions in its slots
    pad = x1t.new_zeros((n, 3 - dim))
    rows = torch.cat([x1t, pad, vt, pad, mt[:, None].float()], dim=1)
    feat = ps.scatter_slots(c["addr"], rows, sg)
    xs, vs = feat[:, 0:dim, :], feat[:, 3:3 + dim, :]
    c.update(feat=feat, xs=xs, vs=vs, x0s=xs if alias_x0s else c["x0s"])
    other = _finish(c, sg, dim, dev, seed=seed + 1)
    return grid, sg, c, x0t, at, mt, other
