"""Minority slot repair in the port (`repair_k`, `make_repair_tools`), the
slot-space membership helpers it shares with the auto-rebuild predicate, and
`default_repair_k`, against the reference's.

Counters (viol, healed, rebuilds, repairs) must be equal and per-particle
results agree as in tests/test_torch_resident.py (whose helpers this file
uses); repair is pure re-addressing, which the port shows bitwise.  The
reference's cases are tests/test_pallas_equiv.py:793-966 and 1070-1080.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import sph_tpu
import sph_tpu_torch as port
from helpers import random_cloud, small_scene
from sph_tpu import neighbors as jnb
from sph_tpu import pallas_step as jps
from sph_tpu import step as ref_step
from sph_tpu.params import Block
from sph_tpu.step import make_advance as ref_make_advance
from sph_tpu_torch import neighbors as tnb
from sph_tpu_torch import pallas_step as tps
from sph_tpu_torch import slot_pass
from sph_tpu_torch import step as port_step
from test_torch_resident import AUTO, CPU, _agree, _emitting, _jet, _pair, _same

torch.set_num_threads(1)


def _dart_scene(seed, target=False):
    """Calm dam + a small fast dart: a risky MINORITY (the repair target);
    target=True aims the dart INTO the dam (test_pallas_equiv.py:793)."""
    base = small_scene(dim=2, seed=seed)
    b0 = base.blocks[0]
    dart = (
        Block(lo=(80.0, 40.0), hi=(90.0, 50.0), velocity=(-450.0, 0.0))
        if target
        else Block(lo=(250.0, 250.0), hi=(262.0, 262.0),
                   velocity=(420.0, 0.0))
    )
    return base.replace(
        blocks=(Block(lo=b0.lo, hi=(b0.lo[0] + 60, b0.lo[1] + 100)), dart)
    )


def _anchor_scene():
    """The deterministic 4-block timeline of test_pallas_equiv.py:865:
    dart A is repaired at blocks 2 and 3, dart B turns risky at block 4."""
    we = 28.7
    base = small_scene(dim=2, seed=97, wall_eps=we)
    return base.replace(blocks=(
        Block(lo=(we + 4, we + 4), hi=(we + 64, we + 104)),
        Block(lo=(367.8, 360.0), hi=(369.8, 362.0), velocity=(420.0, 0.0)),
        Block(lo=(272.6, 249.0), hi=(274.6, 251.0), velocity=(420.0, 0.0)),
        Block(lo=(371.0, 99.0), hi=(373.0, 101.0)),
    ), jitter=0.0)


SCENES = {
    "calm": lambda: small_scene(dim=2, seed=96),
    "dart": lambda: _dart_scene(97),
    "dart_into_dam": lambda: _dart_scene(99, target=True),
    "anchor": _anchor_scene,
    "jet": lambda: _jet(small_scene(dim=2, seed=97)),
    "emitting": lambda: _emitting(small_scene(dim=2, seed=98)),
}


@pytest.mark.parametrize(
    "case,name,spd,repair_k,cap4,want",
    [
        ("noop_on_calm", "calm", 16, 64, False, None),
        ("fast_dart", "dart", 32, 256, False, None),
        ("into_dam_heals", "dart_into_dam", 32, 256, False, None),
        ("anchor_advances", "anchor", 16, 1, False, (0, 0, 1, 3)),
        ("overflow_falls_back", "jet", 12, 4, False, None),
        ("emitter_activation", "emitting", 24, 64, False, None),
        ("full_cells", "dart_into_dam", 32, 256, True, None),
    ],
)
def test_repair_matches_reference(case, name, spd, repair_k, cap4, want):
    rs, rst, scene, ost = _pair(SCENES[name]())
    ref_kw, kw = {}, {}
    if cap4:
        skin = ref_step.default_skin(rs, 4)
        ref_kw["grid"] = jnb.GridSpec.for_scene(rs, cap=4, skin=skin)
        kw["grid"] = tnb.GridSpec.for_scene(scene, cap=4, skin=skin)
    ref = ref_make_advance(rs, "pallas", steps_per_dispatch=spd,
                           repair_k=repair_k, **AUTO, **ref_kw)(rst)
    ours = port.make_advance(scene, "pallas", steps_per_dispatch=spd,
                             repair_k=repair_k, **AUTO, **kw, **CPU)(ost)
    counts = (int(ours[1]), *ours[2:])
    assert counts == tuple(int(c) for c in ref[1:]), case
    if want is not None:
        assert counts == want, case
    assert counts[0] == 0
    _agree(ref[0], ours[0], case)
    plain = port.make_advance(scene, "pallas", steps_per_dispatch=spd,
                              **AUTO, **kw, **CPU)(ost)
    if counts[3] == 0:
        # no repair fired: the machinery is pure extra, bitwise the plain
        # auto advance (heals and rebuilds included)
        assert plain[2:] == counts[1:3]
        _same(plain[0], ours[0], ("x", "v", "rho", "acc"))
    else:
        assert counts[2] < plain[3], case   # repairs replaced rebuilds


def test_repair_is_pure_readdressing():
    """apply() moves slots, never values: the state a carry materializes is
    bitwise the same before and after a repair, and the patched addr
    points every particle at its value.  apply() patches the carry's
    arrays in place, so the state before is read first."""
    _, _, scene, ost = _pair(_dart_scene(97))
    grid = tnb.GridSpec.for_scene(
        scene, cap=tnb.GridSpec.for_scene(scene).cap,
        skin=port.default_skin(scene, 4))
    sg = tps.slot_grid(grid)
    adv = port.make_advance(scene, "pallas", steps_per_dispatch=8,
                            repair_k=256, **AUTO, **CPU)
    st = adv(ost)[0]
    # a carry whose dart slots moved 12 along the lanes' axis (y in 2D:
    # rows are x cells here), past their build cells' faces
    p = scene.params
    sp = port_step._SlotPhysics(scene, grid, sg, torch.device("cpu"))
    c = port_step._residency(st, grid, sg, p.dim, p.dt, False, True)
    dart = c["movb"] & (c["vs"][:, :1] > 100)
    shift = torch.tensor([0.0, 12.0]).reshape(1, 2, 1)
    moved = c["xs"] + torch.where(dart, shift, 0.0)
    c.update(xs=moved, acc=torch.zeros_like(moved),
             rp=torch.arange(sg.c_rows * 2 * sg.lanes, dtype=torch.float32
                             ).reshape(sg.c_rows, 2, sg.lanes))
    budget = 0.5 * port.default_skin(scene, 4)
    plan, apply = port_step.make_repair_tools(grid, sg, p.dim, p.dt, 4,
                                              budget, 256, sp.gather)
    act = st.active
    pl = plan(c, st.x, act, act & (st.kind == 0))
    assert bool(pl["can"]) and int(pl["n_risky"]) > 0
    before = port_step._materialize(sp, c, st, st.step)
    c2 = apply(c, pl)
    after = port_step._materialize(sp, c2, st, st.step)
    _same(before, after)
    assert int(c2["addr"].gcounts.sum()) == int(c["addr"].gcounts.sum())
    assert not torch.equal(c2["addr"].pos, c["addr"].pos)


# Hand-placed carries for the plan's free-lane search on a cap-4 lattice of
# 10-unit cells: `residents` are (cell, count) of particles that stay put,
# `movers` (from cell, to cell) of fast particles that moved.  Cells are
# (row, x) in 2-D and (1, row, x) in 3-D; a cell's particles take its lanes
# in index order, residents first.
PLAN_CAP = 4
PLAN_CARRIES = {
    # three movers, from two other rows and the next x cell, into a cell
    # with one resident: they take its free lanes 1, 2, 3 in index order
    "several_into_one": dict(
        residents=[((2, 3), 1), ((1, 3), 1), ((3, 3), 1), ((2, 2), 1)],
        movers=[((1, 3), (2, 3)), ((3, 3), (2, 3)), ((2, 2), (2, 3))],
        repair_k=8, can=True),
    # a full cell whose lane-2 particle moves inside it: its own lane is
    # the one free lane once it is evicted
    "same_cell_rehome": dict(
        residents=[((2, 3), 2), ((2, 2), 1)],
        movers=[((2, 3), (2, 3))], extra=[((2, 3), 1)],
        repair_k=8, can=True),
    # two full cells swap one particle each: each mover's old slot is the
    # other's only free lane
    "swap_full_cells": dict(
        residents=[((2, 2), 3), ((2, 3), 3)],
        movers=[((2, 2), (2, 3)), ((2, 3), (2, 2))],
        repair_k=8, can=True),
    # a mover into a full cell: no free lane, so no repair
    "no_free_lane": dict(
        residents=[((2, 3), 4), ((2, 2), 1)],
        movers=[((2, 2), (2, 3))],
        repair_k=8, can=False),
    # more movers than repair_k: no repair
    "over_repair_k": dict(
        residents=[((2, 3), 1), ((1, 3), 1), ((3, 3), 1), ((2, 2), 1)],
        movers=[((1, 3), (2, 3)), ((3, 3), (2, 3)), ((2, 2), (2, 3))],
        repair_k=2, can=False),
}


def _plan_carry(dim, residents, movers, extra=(), **_):
    """(grid, sg, carry, x0, movers' indices) of a hand-placed carry: the
    addressing built from every particle at its cell's center (+ a small
    offset by rank), then each mover's slot x set inside its target cell and
    its slot v to 100 (the others' v is 0), so exactly the movers are
    risky.  `extra` cells get particles after the movers (index order is
    lane order)."""
    cell = 10.0
    shape = (6, 6) if dim == 2 else (4, 4, 6)
    grid = tnb.GridSpec(lo=(0.0,) * dim, cell=cell, shape=shape,
                        cap=PLAN_CAP)
    sg = tps.slot_grid(grid)

    def at(c, k):
        c = c if dim == 2 else (1, *c)
        return [(ci + 0.3 + 0.1 * k) * cell for ci in c]

    count = {}

    def place(c):
        k = count.get(c, 0)
        count[c] = k + 1
        return at(c, k)

    x0 = [place(c) for c, n in residents for _ in range(n)]
    first = len(x0)
    x0 += [place(a) for a, _ in movers]
    x0 += [place(c) for c, n in extra for _ in range(n)]
    x1 = [at(b, 5) for _, b in movers]
    x0 = torch.tensor(x0, dtype=torch.float32)
    n = x0.shape[0]
    act = torch.ones(n, dtype=torch.bool)
    c = port_step._scatter_residency(x0, torch.zeros_like(x0), act, act,
                                     grid, sg, use_mem=False)
    addr = c["addr"]
    assert bool(addr.ok().all())
    mv = torch.arange(first, first + len(movers))
    row, pos = addr.row_pos[mv].long(), addr.pos[mv].long()
    xs, vs = c["xs"].clone(), c["vs"].clone()
    xs[row, :, pos] = torch.tensor(x1, dtype=torch.float32)
    vs[row, :, pos] = 100.0
    c.update(xs=xs, vs=vs)
    return grid, sg, c, x0, mv


def _full_storage_plan(pl, c, grid, sg, repair_k):
    """`new_pos` and `can` of a plan by the formula that scans every cell's
    free lanes and then gathers the movers' target cells: the yardstick of
    the per-target-cell search."""
    i32, i64 = torch.int32, torch.int64
    vm, old_row, old_pos = pl["vm"], pl["old_row"], pl["old_pos"]
    new_row, n_risky = pl["new_row"], pl["n_risky"]
    ci_m, _ = tnb.cell_index(pl["x_m"], vm, grid)
    hx_m = ci_m[:, -1] + sg.xc
    size = sg.c_rows * sg.lanes
    occ = torch.cat([(c["xs"][:, 0, :] < 1e17).reshape(-1),
                     torch.zeros(1, dtype=torch.bool)])
    occ.index_put_(
        (torch.where(vm, old_row.long() * sg.lanes + old_pos.long(), size),),
        torch.zeros((), dtype=torch.bool))
    occ3 = occ[:size].reshape(sg.c_rows * sg.h2, sg.cap)
    cumfree = torch.cumsum((~occ3).to(i32), dim=1)
    cellkey = new_row * sg.h2 + hx_m
    key = torch.where(vm, cellkey, 2**30)
    order = torch.argsort(key, stable=True)
    ksort = key[order]
    first = torch.searchsorted(ksort, ksort)
    rank = torch.empty(repair_k, dtype=i64).scatter_(
        0, order, torch.arange(repair_k) - first)
    rowsel = torch.clamp(cellkey, 0, sg.c_rows * sg.h2 - 1).long()
    onehot = (~occ3[rowsel]) & (cumfree[rowsel] == (rank + 1)[:, None])
    placeable = torch.any(onehot, dim=1)
    lane_in = torch.argmax(onehot.to(i32), dim=1).to(i32)
    new_pos = hx_m * sg.cap + lane_in
    can = ((n_risky <= repair_k) & (n_risky > 0)
           & ~torch.any(vm & ((new_row == 0) | ~placeable)))
    return {**pl, "new_pos": new_pos, "can": can}


@pytest.mark.parametrize("carry", sorted(PLAN_CARRIES))
@pytest.mark.parametrize("dim", [2, 3])
def test_repair_plan_matches_full_storage_search(dim, carry):
    """The plan, which counts free lanes in the movers' target cells only,
    returns bitwise the dict of the formula that counts them over the whole
    slot storage, on carries that reach each branch of the search."""
    spec = PLAN_CARRIES[carry]
    repair_k = spec["repair_k"]
    grid, sg, c, x0, mv = _plan_carry(dim, **spec)
    act = torch.ones(x0.shape[0], dtype=torch.bool)
    plan, _ = port_step.make_repair_tools(
        grid, sg, dim, 1.0, 1, 1.0, repair_k, port_step._SlotPhysics.gather)
    pl = plan(c, x0, act, act)
    want = _full_storage_plan(pl, c, grid, sg, repair_k)
    assert sorted(pl) == sorted(want) == [
        "can", "n_risky", "new_pos", "new_row", "old_pos", "old_row", "pids",
        "vm", "x_m"]
    for k in want:
        assert pl[k].dtype == want[k].dtype, k
        assert torch.equal(pl[k], want[k]), k
    # the carry reaches the branch it names
    n_mv = len(mv)
    assert int(pl["n_risky"]) == n_mv
    assert bool(pl["can"]) == spec["can"]
    taken = min(n_mv, repair_k)
    assert torch.equal(pl["pids"][:taken], mv[:taken])
    assert int(pl["vm"].sum()) == taken
    lanes = (pl["new_pos"] % PLAN_CAP)[:taken].tolist()
    if carry == "several_into_one":
        assert lanes == [1, 2, 3]
    elif carry == "same_cell_rehome":
        assert torch.equal(pl["new_pos"][:1], pl["old_pos"][:1])
        assert lanes == [2]
    elif carry == "swap_full_cells":
        assert lanes == [3, 3]
        assert (pl["new_pos"][:2] // PLAN_CAP).tolist() == (
            pl["old_pos"][:2] // PLAN_CAP).flip(0).tolist()
    elif carry == "no_free_lane":
        assert int(pl["new_row"][0]) > 0


@pytest.mark.parametrize("dim", [2, 3])
def test_repair_plan_scans_target_cells_only(dim, monkeypatch):
    """No scan of the plan sees as many elements as the slot storage
    (`c_rows · lanes`): its 2-D scan is the movers' [repair_k, cap] block."""
    spec = PLAN_CARRIES["several_into_one"]
    grid, sg, c, x0, _ = _plan_carry(dim, **spec)
    act = torch.ones(x0.shape[0], dtype=torch.bool)
    plan, _ = port_step.make_repair_tools(
        grid, sg, dim, 1.0, 1, 1.0, spec["repair_k"],
        port_step._SlotPhysics.gather)
    seen = []
    fn, meth = torch.cumsum, torch.Tensor.cumsum

    def record(t, *a, **kw):
        seen.append(tuple(t.shape))
        return fn(t, *a, **kw)

    def record_meth(self, *a, **kw):
        seen.append(tuple(self.shape))
        return meth(self, *a, **kw)

    monkeypatch.setattr(torch, "cumsum", record)
    monkeypatch.setattr(torch.Tensor, "cumsum", record_meth)
    pl = plan(c, x0, act, act)
    monkeypatch.undo()
    assert bool(pl["can"])
    size = sg.c_rows * sg.lanes
    assert all(int(np.prod(s)) < size for s in seen), (seen, size)
    assert [s for s in seen if len(s) == 2] == [(spec["repair_k"], sg.cap)]


@pytest.mark.parametrize("name", sph_tpu.preset_names())
def test_repair_default_capacity_gate(name):
    ref_scene, scene = sph_tpu.preset(name), port.preset(name)
    assert port_step._seed_estimate(scene) == ref_step._seed_estimate(ref_scene)
    for auto in (False, True):
        for packed_rows in (False, True):
            assert port_step.default_repair_k(
                scene, auto=auto, packed_rows=packed_rows
            ) == ref_step.default_repair_k(
                ref_scene, auto=auto, packed_rows=packed_rows)
    assert port_step.DEFAULT_REPAIR_K == ref_step.DEFAULT_REPAIR_K
    assert port_step.REPAIR_MIN_N == ref_step.REPAIR_MIN_N
    assert port_step.DEMOTE_PATIENCE == ref_step.DEMOTE_PATIENCE
    assert port_step.PERSTEP_REPROBE_EVERY == ref_step.PERSTEP_REPROBE_EVERY


@pytest.mark.parametrize("packed", [False, True], ids=["slot", "packed"])
@pytest.mark.parametrize("dim", [2, 3])
def test_membership_helpers_match_reference(dim, packed):
    """`slot_bin_refs`, `slot_inside_bin`, `slot_bin_margin` and
    `membership_risky` (`sph_tpu_torch.slot_pass`) on the slot arrays of a
    cloud whose particles moved after the build: equal to the reference's
    on every real slot."""
    n = 300
    x, v = random_cloud(n, dim, 0.0, 120.0, seed=61 + dim, vmax=300.0)
    x, v = x[:, :dim], v[:, :dim]
    active = np.ones(n, bool)
    active[-20:] = False
    p = sph_tpu.SimParams(dim=dim, gravity=(0.0,) * dim)
    ref_scene = sph_tpu.Scene(params=p, lo=(0.0,) * dim, hi=(120.0,) * dim)
    scene = port.scene_from_json(sph_tpu.scene_to_json(ref_scene))
    skin = 4.0
    rg = jnb.GridSpec.for_scene(ref_scene, cap=16, skin=skin)
    tg = tnb.GridSpec.for_scene(scene, cap=16, skin=skin)
    rsg = jps.packed_grid(rg, 256) if packed else jps.slot_grid(rg)
    tsg = tps.packed_grid(tg, 256) if packed else tps.slot_grid(tg)
    raddr = jps.build_addr(jnp.asarray(x), jnp.asarray(active), rg, rsg)
    taddr = tps.build_addr(torch.from_numpy(x), torch.from_numpy(active),
                           tg, tsg)
    rows = np.concatenate([x, np.zeros((n, 3 - dim), np.float32),
                           v, np.zeros((n, 3 - dim), np.float32)], axis=1)
    rfeat = np.array(jps.scatter_slots(raddr, jnp.asarray(rows), rsg))
    tfeat = tps.scatter_slots(taddr, torch.from_numpy(rows), tsg)
    assert np.array_equal(rfeat, tfeat.numpy())
    real = rfeat[:, 0, :] < 1e17
    # positions one step of v·dt later: some slots leave their build cell
    dt = 0.01
    x0s = rfeat[:, 0:dim, :]
    xs = x0s + dt * rfeat[:, 3:3 + dim, :]
    vs = rfeat[:, 3:3 + dim, :]
    r_refs = ref_step._slot_bin_refs(raddr, rsg)
    t_refs = slot_pass.slot_bin_refs(taddr, tsg)
    assert len(r_refs) == len(t_refs) == dim
    for k, (a, b) in enumerate(zip(r_refs, t_refs)):
        exempt = packed and k == dim - 1      # packed rows: x has no ref
        assert (a is None) == (b is None) == exempt
        if a is not None:
            ra, tb = np.broadcast_arrays(np.asarray(a), b.numpy())
            assert np.array_equal(ra, tb)
    r_in = np.asarray(ref_step._slot_inside_bin(jnp.asarray(xs), r_refs, rg))
    t_in = slot_pass.slot_inside_bin(torch.from_numpy(xs), t_refs, tg).numpy()
    assert np.array_equal(r_in[:, 0][real], t_in[:, 0][real])
    assert 0 < (~t_in[:, 0][real]).sum() < real.sum()
    r_m = np.asarray(ref_step._slot_bin_margin(jnp.asarray(xs), r_refs, rg))
    t_m = slot_pass.slot_bin_margin(torch.from_numpy(xs), t_refs, tg).numpy()
    assert np.array_equal(r_m[:, 0][real], t_m[:, 0][real])
    dd = xs - x0s
    dd2 = np.sum(dd * dd, axis=1, keepdims=True)
    movb = real[:, None, :]
    budget = 0.5 * skin
    r_c = dict(xs=jnp.asarray(xs), vs=jnp.asarray(vs), movb=jnp.asarray(movb))
    r_risky = np.asarray(ref_step._membership_risky(
        r_c, raddr, rsg, rg, jnp.asarray(dd2), dt, 4, budget))
    t_c = dict(xs=torch.from_numpy(xs), vs=torch.from_numpy(vs),
               movb=torch.from_numpy(movb), refs=t_refs)
    t_risky = slot_pass.membership_risky(
        t_c, tg, torch.from_numpy(dd2), dt, 4, budget).numpy()
    assert np.array_equal(r_risky, t_risky)
    assert t_risky.any()
