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
    points every particle at its value."""
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
    c2 = apply(c, pl)
    before = port_step._materialize(sp, c, st, st.step)
    after = port_step._materialize(sp, c2, st, st.step)
    _same(before, after)
    assert int(c2["addr"].gcounts.sum()) == int(c["addr"].gcounts.sum())
    assert not torch.equal(c2["addr"].pos, c["addr"].pos)


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
    """`_slot_bin_refs`, `_slot_inside_bin`, `_slot_bin_margin` and
    `_membership_risky` on the slot arrays of a cloud whose particles moved
    after the build: equal to the reference's on every real slot."""
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
    t_refs = port_step._slot_bin_refs(taddr, tsg)
    assert len(r_refs) == len(t_refs) == dim
    for k, (a, b) in enumerate(zip(r_refs, t_refs)):
        exempt = packed and k == dim - 1      # packed rows: x has no ref
        assert (a is None) == (b is None) == exempt
        if a is not None:
            ra, tb = np.broadcast_arrays(np.asarray(a), b.numpy())
            assert np.array_equal(ra, tb)
    r_in = np.asarray(ref_step._slot_inside_bin(jnp.asarray(xs), r_refs, rg))
    t_in = port_step._slot_inside_bin(torch.from_numpy(xs), t_refs, tg).numpy()
    assert np.array_equal(r_in[:, 0][real], t_in[:, 0][real])
    assert 0 < (~t_in[:, 0][real]).sum() < real.sum()
    r_m = np.asarray(ref_step._slot_bin_margin(jnp.asarray(xs), r_refs, rg))
    t_m = port_step._slot_bin_margin(torch.from_numpy(xs), t_refs, tg).numpy()
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
    t_risky = port_step._membership_risky(
        t_c, tg, torch.from_numpy(dd2), dt, 4, budget).numpy()
    assert np.array_equal(r_risky, t_risky)
    assert t_risky.any()
