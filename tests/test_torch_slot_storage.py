"""The resident block's storage that outlives the block
(`sph_tpu_torch.slot_pass.SlotStore`), against the fresh storage every
block had before (`slot_pass.FRESH_STORAGE = True`: a new `SlotBlock` and
the first slot_pre over every slot).

With the persistent storage a block writes the array its top does not
hold, and its first slot_pre visits only the occupied groups whenever that
array was filled for the block's addressing.  Every result must be bitwise
the fresh storage's: x, v, acc, rho, p and the rest of the state, and every
counter (viol, healed, rebuilds, repairs, the policies' modes), since the
audit's compares decide heals, rebuilds and repairs.  Each case also counts
its blocks by first pass (`slot_pass.BLOCKS`), so that a case that ran only
full passes cannot pass for the new design.  The cases are small CPU clouds
of the port alone; the port against the reference is in
tests/test_torch_resident.py, _repair.py, _policy.py, _adaptive.py and
_decomp_fast.py, which run the persistent storage.
"""

import pytest
import torch

import sph_tpu_torch as port
import torch_decomp_worker as worker
from sph_tpu_torch import comm, decomp, slot_pass
from sph_tpu_torch import neighbors as tnb
from sph_tpu_torch import pallas_step as tps
from sph_tpu_torch import step as port_step

torch.set_num_threads(1)

CPU = dict(device="cpu")
AUTO = dict(sort_every=4, slot_resident=True, auto_rebuild=True)
FIELDS = ("x", "v", "acc", "rho", "p", "kind", "emit_step", "step")


# ---------------------------------------------------------------------------
# Scenes (the port's twins of tests/helpers.py and the resident tests')
# ---------------------------------------------------------------------------


def small_scene(dim=2, seed=0, **kw):
    if dim == 2:
        p = port.SimParams(**kw)
        lo = (p.wall_eps + 4, p.wall_eps + 4)
        return port.calibrate(port.Scene(
            params=p, lo=(0.0, 0.0), hi=(400.0, 400.0),
            blocks=(port.Block(lo=lo, hi=(lo[0] + 120, lo[1] + 200)),),
            seed=seed))
    p = port.SimParams(**{"dim": 3, "gravity": (0.0, -9.81, 0.0),
                          "kernel_norm": "proper", **kw})
    lo = (p.wall_eps + 4,) * 3
    return port.calibrate(port.Scene(
        params=p, lo=(0.0,) * 3, hi=(300.0,) * 3,
        blocks=(port.Block(lo=lo, hi=(lo[0] + 90, lo[1] + 120,
                                      lo[2] + 90)),),
        seed=seed))


def dart_scene(seed, target=False):
    """A calm dam and a small fast dart (tests/test_torch_repair.py): the
    risky minority a repair re-homes; `target` aims it into the dam, whose
    blocks then heal."""
    base = small_scene(seed=seed)
    b0 = base.blocks[0]
    dart = (port.Block(lo=(80.0, 40.0), hi=(90.0, 50.0),
                       velocity=(-450.0, 0.0)) if target
            else port.Block(lo=(250.0, 250.0), hi=(262.0, 262.0),
                            velocity=(420.0, 0.0)))
    return base.replace(blocks=(
        port.Block(lo=b0.lo, hi=(b0.lo[0] + 60, b0.lo[1] + 100)), dart))


def jet_scene(seed):
    base = small_scene(seed=seed)
    return base.replace(blocks=(port.Block(
        lo=base.blocks[0].lo, hi=base.blocks[0].hi,
        velocity=(2000.0, 0.0)),))


def leap3d():
    return small_scene(dim=3, seed=74, eos="tait", integrator="leapfrog",
                       boundary_mode="penalty", dt=4e-4)


def start(scene):
    st = port.init(scene, **CPU)
    if scene.params.integrator == "leapfrog":
        st = port.prime(scene, st, "pallas", **CPU)
    return st


# ---------------------------------------------------------------------------
# The persistent storage against the fresh one
# ---------------------------------------------------------------------------


def _bits(t):
    if t.dtype == torch.bool:
        return t
    return t.contiguous().view({8: torch.int64, 4: torch.int32,
                                2: torch.int16, 1: torch.int8}[
                                    t.element_size()])


def _equal(a, b, what=""):
    """a == b bit for bit: States field by field, tensors by their bits
    (so -0 and +0 differ), lists, tuples and dicts item by item."""
    if isinstance(a, port.State):
        for f in FIELDS:
            _equal(getattr(a, f), getattr(b, f), f"{what}.{f}")
    elif isinstance(a, torch.Tensor):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{k}]")
    else:
        assert a == b, (what, a, b)


def _both(monkeypatch, fn):
    """fn() with the persistent storage, then with fresh storage: the two
    results bitwise equal; → (result, the persistent run's BLOCKS, the
    fresh run's)."""
    out = []
    for fresh in (False, True):
        monkeypatch.setattr(slot_pass, "FRESH_STORAGE", fresh)
        slot_pass.reset_launches()
        out.append((fn(), dict(slot_pass.BLOCKS)))
    (a, blocks), (b, fresh_blocks) = out
    _equal(a, b)
    kinds = ("after_build", "after_repair", "plain")
    assert {k: blocks[k] for k in kinds} == {k: fresh_blocks[k]
                                             for k in kinds}
    assert fresh_blocks["occupied"] == 0
    assert fresh_blocks["full"] == blocks["full"] + blocks["occupied"]
    return a, blocks, fresh_blocks


def _dispatches(adv, st, n):
    outs = []
    for _ in range(n):
        res = adv(st)
        st = res[0]
        outs.append(tuple(int(t) if not isinstance(t, port.State) else t
                          for t in res))
    return outs


def _auto(scene, spd, n=1, **kw):
    return lambda: _dispatches(port.make_advance(
        scene, "pallas", steps_per_dispatch=spd, **AUTO, **kw, **CPU),
        start(scene), n)


@pytest.mark.parametrize("name,scene,spd", [
    ("2d", lambda: small_scene(seed=96), 16),
    ("3d-leapfrog", leap3d, 16),
])
def test_plain_blocks_visit_the_occupied_groups(monkeypatch, name, scene,
                                                spd):
    """A calm dispatch of four blocks: the block after the entry build gets
    the full pass, the three after it the occupied groups only."""
    out, blocks, _ = _both(monkeypatch, _auto(scene(), spd))
    (st, viol, healed, rebuilds), = out
    assert (viol, healed, rebuilds) == (0, 0, 1)
    assert blocks == {"full": 1, "occupied": 3, "after_build": 1,
                      "after_repair": 0, "plain": 3}


def test_rebuilds_fill_once_per_build(monkeypatch):
    """A dart that keeps tripping the rebuild predicate: each rebuild's
    block gets the one full pass of its addressing (its scatter array then
    joins the store), every other block the occupied groups."""
    out, blocks, _ = _both(monkeypatch, _auto(dart_scene(97), 32, n=2))
    rebuilds = sum(o[3] for o in out)
    assert blocks["after_build"] >= 4 and rebuilds >= blocks["after_build"]
    assert blocks["full"] == blocks["after_build"]
    assert blocks["occupied"] == blocks["plain"] > 0


def test_repairs_patch_both_storages(monkeypatch):
    """Minority repair re-homes the dart between groups: it patches the
    top and the other filled storage in place, and the block after it
    visits the occupied groups of the repaired addressing."""
    out, blocks, _ = _both(monkeypatch, _auto(dart_scene(97), 32, n=2,
                                              repair_k=256))
    assert sum(o[4] for o in out) == blocks["after_repair"] > 0
    assert blocks["full"] == blocks["after_build"]
    assert blocks["occupied"] == blocks["after_repair"] + blocks["plain"]


def test_heals_refill(monkeypatch):
    """A dart into the dam: blocks heal and re-enter residency; the block
    after each heal's build gets the full pass."""
    out, blocks, _ = _both(monkeypatch, _auto(dart_scene(99, target=True),
                                              32, repair_k=256))
    (st, viol, healed, rebuilds, repairs), = out
    assert healed > 0 and viol == 0
    assert blocks["full"] == blocks["after_build"] and blocks["occupied"] > 0


def test_every_block_heals(monkeypatch):
    """A jet whose every block heals: no block's storage is ever filled
    twice for one addressing, so every first pass is full."""
    out, blocks, _ = _both(monkeypatch, _auto(jet_scene(97), 12))
    (st, viol, healed, rebuilds), = out
    assert healed == 3 and blocks["occupied"] == 0


def test_cap8_switch_starts_a_new_store(monkeypatch):
    """The cap-8 policy on a jet: every block of the first dispatch heals
    and the policy switches to the default cap, whose lattice the next
    dispatch runs on with a store of its own."""
    scene = small_scene(seed=94)
    scene = scene.replace(blocks=(port.Block(
        lo=scene.blocks[0].lo, hi=scene.blocks[0].hi,
        velocity=(2000.0, 0.0)),))

    def run():
        adv = port.make_audited_advance(scene, "pallas", 12,
                                        adaptive_cap=True, sort_every=4,
                                        slot_resident=True, **CPU)
        st, modes = start(scene), []
        for _ in range(2):
            st = adv(st)
            modes.append(adv.mode)
        return st, modes, adv.healed

    (st, modes, healed), blocks, _ = _both(monkeypatch, run)
    assert modes == ["cap16", "cap16"] and healed >= 3
    assert blocks["after_build"] >= 4


def test_demotion_and_reprobe(monkeypatch):
    """vortex2d's constant-heal demotion (tests/test_torch_policy.py): two
    kicked dispatches demote to per step, calm ones re-probe the resident
    path, which starts its storage anew."""
    monkeypatch.setattr(port_step, "PERSTEP_REPROBE_EVERY", 2)
    scene = small_scene(seed=17)
    budget = port.default_skin(scene, 4) / 2.0
    kick = 3.0 * budget / (4 * scene.params.dt)

    def run():
        adv = port.make_audited_advance(scene, "pallas", 8, sort_every=4,
                                        slot_resident=True, **CPU)
        st, modes = start(scene), []
        for what in ("kick", "kick", "calm", "calm", "calm"):
            n, d = st.x.shape
            sign = torch.where(torch.arange(n)[:, None] % 2 == 0, 1.0, -1.0)
            v = (torch.where(st.active[:, None], kick * sign, 0.0)
                 * torch.ones((1, d))) if what == "kick" else \
                torch.zeros_like(st.v)
            st = adv(st.replace(v=v.to(torch.float32)))
            modes.append(adv.mode)
        return st, modes, adv.healed

    (st, modes, healed), blocks, _ = _both(monkeypatch, run)
    assert "perstep" in modes and modes[-1] == "resident"
    assert blocks["occupied"] > 0


@pytest.mark.parametrize("kind", ["bf16", "packed_scatter"])
def test_storage_that_does_not_join(monkeypatch, kind):
    """bf16 features, and the packed_scatter transport (whose x and v are
    not a feature array): the build's arrays do not join the store, so the
    first two blocks after a build get the full pass and the rest the
    occupied groups."""
    if kind == "bf16":
        scene, kw = small_scene(seed=96, precision="bf16"), {}
    else:
        scene, kw = small_scene(seed=96), dict(packed_scatter=True)
    out, blocks, _ = _both(monkeypatch, _auto(scene, 16, **kw))
    assert out[0][1:] == (0, 0, 1)
    assert blocks["full"] == 2 and blocks["occupied"] == 2


def test_pinned_packed_rows(monkeypatch):
    """Pinned packed resident: packed rows' groups fill from the left, and
    the storage alternates as on the slot layout."""
    scene = small_scene(seed=96)
    out, blocks, _ = _both(monkeypatch, _auto(scene, 16, packed_rows=True))
    assert out[0][1:] == (0, 0, 1)
    assert blocks == {"full": 1, "occupied": 3, "after_build": 1,
                      "after_repair": 0, "plain": 3}


def test_run_production_default(monkeypatch):
    """`run` with the production default (its audited policy, repair_k
    resolved, dispatches of 8) on a 3D dam."""
    scene = leap3d()

    def run():
        return port.run(scene, 24, method="pallas", steps_per_dispatch=8,
                        sort_every=4, slot_resident=True, **CPU)

    st, blocks, _ = _both(monkeypatch, run)
    assert int(st.step) == 24
    assert blocks["full"] == blocks["after_build"] >= 3
    assert blocks["occupied"] > 0


# ---------------------------------------------------------------------------
# The slab fast path
# ---------------------------------------------------------------------------


def emit_heal_scene():
    """The calm pool of the fast-path suite and an 8000 px/s emitter that
    fires at step 6: the third block of a 16-step dispatch rebuilds for
    the activation, from the accepted second block's end, and heals, so
    the slab fast path re-runs it from that block's arrays."""
    base = worker.pool(port, **worker.LT)
    return port.calibrate(base.replace(
        emitters=(port.Emitter(pos=(300.0, 250.0), velocity=(8000.0, 0.0),
                               width=2, start_step=6, stop_step=7),),
        capacity=1024 + 64))


@pytest.mark.parametrize("name,repair_k,n", [
    ("dart", 64, 2), ("migrate", 0, 3), ("jet", 0, 1), ("emit_heal", 0, 1)])
def test_slab_fast_path_on_one_rank(monkeypatch, name, repair_k, n):
    """The slab fast path on a one-rank gloo world: its rebuilds' carries
    are `drifted` (their first step's kick, drift and exchange came before
    the build), its ghosts are particles of the addressing, and a heal of
    a rebuilt block reads the last block's arrays."""
    scene = (emit_heal_scene() if name == "emit_heal"
             else worker.fast_scene(port, name))
    st = start(scene)

    def run():
        with comm.joined("gloo", alone=True):
            spec = decomp.SpatialSpec.for_scene(scene, 1, st.capacity,
                                                balance=8.0)
            loc = decomp.spatial_shard_state(st, scene, spec,
                                             torch.device("cpu"))
            adv = decomp.make_spatial_advance(
                scene, spec, "pallas", 16, **AUTO, repair_k=repair_k)
            outs = []
            for _ in range(n):
                res = adv(loc)
                loc = res[0]
                outs.append([int(t) for t in res[1:]])
            return decomp.spatial_gather_state(loc), outs

    (st2, outs), blocks, _ = _both(monkeypatch, run)
    # (worst, rebuilds, healed[, repairs]) a dispatch: at most one full
    # pass a build (a repair right after one re-addresses before its block)
    assert blocks["full"] <= sum(o[1] for o in outs)
    if name != "jet":
        assert blocks["occupied"] > 0
    if repair_k:
        assert blocks["after_repair"] == sum(o[3] for o in outs) > 0
    if name == "migrate":
        # more builds than dispatches: a rebuild mid-dispatch, whose carry
        # is drifted
        assert sum(o[1] for o in outs) > n
    if name == "emit_heal":
        assert outs == [[0, 3, 1]]       # the entry, the activation, a heal


def test_slab_fast_path_on_gloo_ranks(tmp_path):
    """Four gloo ranks (`torch_decomp_worker.py`, suite "storage"): the
    dart repaired mid-dispatch, the migrating block's rebuilds (drifted
    carries) and the heals of the jet, each bitwise the fresh storage on
    every rank, with occupied-only first passes wherever a block's
    storage was filled."""
    got = worker.join(worker.spawn("storage", 4, tmp_path), tmp_path)
    for case in worker.STORAGE_RUNS:
        for r in range(4):
            res = got[f"{case}_r{r}"]
            assert bool(res["bitwise"]), (case, r)
            full, occupied, after_build, after_repair = res["blocks"]
            # counts: worst, rebuilds, healed[, repairs]
            assert full <= res["counts"][1], (case, r)
            if case != "storage_jet":
                assert occupied > 0, (case, r)
            if case == "storage_dart":
                assert after_repair > 0, (case, r)
            if case == "storage_migrate":
                # more builds than dispatches: a rebuild mid-dispatch,
                # whose carry is drifted
                assert res["counts"][1] > worker.STORAGE_RUNS[case][1]


# ---------------------------------------------------------------------------
# The store itself
# ---------------------------------------------------------------------------


def _carry(scene, dev="cpu"):
    """A fresh build's carry on the sort_every=4 lattice, as the auto
    advance enters residency, and its slot physics."""
    p = scene.params
    st = start(scene)
    grid = tnb.GridSpec.for_scene(scene, cap=tnb.GridSpec.for_scene(
        scene).cap, skin=port.default_skin(scene, 4))
    sg = tps.slot_grid(grid)
    c = port_step._residency(st, grid, sg, p.dim, p.dt,
                             p.integrator == "leapfrog", True)
    c.update(acc=torch.zeros_like(c["xs"]),
             rp=c["xs"].new_zeros((sg.c_rows, 2, sg.lanes)))
    return port_step._SlotPhysics(scene, grid, sg, torch.device(dev)), c


def _block(sp, c, store=None):
    half2 = (0.5 * port.default_skin(sp.scene, 4)) ** 2
    xs, vs, acc, rp, viol, _ = port_step._slot_steps(
        sp, c, 4, half2, True, sp.params.integrator == "leapfrog",
        store=store)
    return {**c, "xs": xs, "vs": vs, "acc": acc, "rp": rp}


def test_storage_alternates_and_the_build_joins():
    """Block 1 after a build writes a new storage and copies the build's
    positions into the store's x0; the build's scatter array then joins,
    block 2 writes it, and block 3 writes block 1's storage again."""
    sp, c0 = _carry(leap3d())
    feat0 = c0["feat"]
    store = slot_pass.SlotStore(sp.sg, sp.d, False, "cpu")
    x0 = c0["xs"].clone()
    c1 = _block(sp, c0, store)
    assert c1["x0s"] is store.x0 and torch.equal(store.x0, x0)
    assert c1["xs"].data_ptr() != feat0.data_ptr()
    assert [h.feat.data_ptr() for h in store.halves][1] == feat0.data_ptr()
    c2 = _block(sp, c1, store)
    assert c2["xs"].data_ptr() == feat0.data_ptr()
    c3 = _block(sp, c2, store)
    assert c3["xs"].data_ptr() == c1["xs"].data_ptr()
    assert len(store.halves) == 2


def test_a_rebuilt_block_keeps_the_last_blocks_storage():
    """A carry rebuilt from the last block's end: the block after the
    build writes neither the build's array nor the last block's storage,
    which the carry the rebuild replaced still holds."""
    sp, c0 = _carry(leap3d())
    store = slot_pass.SlotStore(sp.sg, sp.d, False, "cpu")
    c = c0
    for _ in range(3):                     # the last block in the first
        c = _block(sp, c, store)           # storage of the list
    assert c["xs"].data_ptr() == store.halves[0].feat.data_ptr()
    _, c_new = _carry(leap3d())            # a new build (its own array)
    blk, full, x0 = store.take(c_new)
    assert full and x0 is not None
    assert blk.feat.data_ptr() not in (c["xs"].data_ptr(),
                                       c_new["xs"].data_ptr())


def test_dirty_storage_is_refilled_not_used():
    """A storage filled for another addressing holds that addressing's
    particles in what are now empty slots.  The store does not take it for
    filled: the block gets the full pass and its results are the fresh
    storage's.  Taken as filled (the control), the stale slots reach
    K1/K2 and the results differ."""
    scene = small_scene(seed=96)
    sp, _ = _carry(scene)
    st = start(scene)
    shift = torch.tensor([11.0, 150.0]) * st.active[:, None]
    p = scene.params
    c = port_step._residency(st.replace(x=st.x + shift), sp.grid, sp.sg,
                             p.dim, p.dt, False, True)
    c.update(acc=torch.zeros_like(c["xs"]),
             rp=c["xs"].new_zeros((sp.sg.c_rows, 2, sp.sg.lanes)))
    fresh = _block(sp, dict(c))
    results = []
    for lie in (False, True):
        _, c_old = _carry(scene)         # a build's array joins the store
        store = slot_pass.SlotStore(sp.sg, sp.d, False, "cpu")
        _block(sp, c_old, store)         # both storages: c_old's
        assert all(h.addr is c_old["addr"] for h in store.halves)
        if lie:
            for h in store.halves:
                h.addr = c["addr"]
        slot_pass.reset_launches()
        results.append((_block(sp, dict(c), store),
                        dict(slot_pass.BLOCKS)))
    (got, blocks), (bad, bad_blocks) = results
    assert blocks["full"] == 1 and bad_blocks["occupied"] == 1
    for k in ("xs", "vs", "acc", "rp"):
        _equal(got[k], fresh[k], k)
    assert not all(torch.equal(_bits(bad[k]), _bits(fresh[k]))
                   for k in ("xs", "vs", "rp"))


def test_repair_patches_in_place(monkeypatch):
    """A repair on the dart's dispatch writes the carry's six slot arrays
    in place (their storage unchanged) and the other filled storage at
    the same slots with the same values, and leaves both filled for the
    repaired addressing."""
    seen = []
    real = port_step.make_repair_tools

    def tools(*args, **kw):
        plan_t, apply_t = real(*args, **kw)

        def apply(c, plan, also=(), **kw):
            keys = ("xs", "vs", "acc", "x0s", "rp", "movb")
            ptrs = {k: c[k].data_ptr() for k in keys}
            c2 = apply_t(c, plan, also, **kw)
            vm = plan["vm"]
            moved = [(plan[a][vm].long(), plan[b][vm].long())
                     for a, b in (("old_row", "old_pos"),
                                  ("new_row", "new_pos"))]
            same = all(torch.equal(_bits(c2[k][r, :, q]),
                                   _bits(getattr(h, k)[r, :, q]))
                       for h in also for r, q in moved
                       for k in ("xs", "vs", "acc"))
            seen.append(({k: c2[k].data_ptr() for k in keys} == ptrs,
                         len(also), same, int(vm.sum())))
            return c2

        return plan_t, apply

    monkeypatch.setattr(port_step, "make_repair_tools", tools)
    scene = dart_scene(97)
    adv = port.make_advance(scene, "pallas", steps_per_dispatch=32,
                            repair_k=256, **AUTO, **CPU)
    slot_pass.reset_launches()
    *_, repairs = adv(start(scene))
    assert repairs == len(seen) > 0
    assert all(in_place and same and n > 0
               for in_place, _, same, n in seen)
    assert any(n_also == 1 for _, n_also, _, _ in seen)
    assert slot_pass.BLOCKS["after_repair"] == repairs
