"""The minority repair's wrappers (`sph_tpu_torch.repair.make_repair_tools`)
on the host, where they run the plain sequence (`make_repair_tools_plain`)
and launch nothing: each hand-placed carry reaches the branch it names and
its apply moves exactly the movers' slots; a random cloud's plan keeps the
plan's invariants; a slab's call (its index offset, faces and band) is the
plain plan with the face test the slab advance built itself, plans on the
shifted lattice as on the unshifted one, and is vetoed by a mover in a
band; the wrappers reject what the kernels do not take.  The card's side,
each kernel bitwise its plain version on these carries (a slab's too), is
in tests/test_torch_gpu.py; the plan against the reference and a
full-storage search in tests/test_torch_repair.py.
"""

import copy

import numpy as np
import pytest
import torch

from sph_tpu_torch import neighbors, repair
from sph_tpu_torch import step as port_step
from torch_repair_carries import PLACED, SLABS, clone, cloud, placed, slab

torch.set_num_threads(1)

GATHER = port_step._SlotPhysics.gather
PLAN_KEYS = ("can", "n_risky", "pids", "vm", "x_m", "old_row", "old_pos",
             "new_row", "new_pos")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _tools(grid, sg, dim, repair_k, plain=False, **kw):
    make = (repair.make_repair_tools_plain if plain
            else repair.make_repair_tools)
    return make(grid, sg, dim, 1.0, 1, 1.0, repair_k, GATHER, **kw)


def _check_moved(c, other, pl, out, o2, x0, sg):
    """The repaired carry `out` (and `o2`, the other storage patched beside
    it) against the carry `c` before: each mover's new slot holds its x_m
    and the v, acc, rp of its old slot, its old slot (unless it is a new
    one) the empty values, every other slot what it held; the addressing
    points the movers at their new slots and counts them there; the
    anchors are x_m at the movers."""
    vm = pl["vm"]
    k = int(vm.sum())
    assert bool(vm[:k].all()) and not bool(vm[k:].any())
    pids = pl["pids"][:k]
    ro, po, rn, pn = (pl[n][:k].long() for n in (
        "old_row", "old_pos", "new_row", "new_pos"))
    x_m = pl["x_m"][:k]
    old = {(int(r), int(p)) for r, p in zip(ro, po)}
    new = {(int(r), int(p)) for r, p in zip(rn, pn)}
    assert len(old) == len(new) == k
    emptied = sorted(old - new)
    er = torch.tensor([r for r, _ in emptied], dtype=torch.long)
    ep = torch.tensor([p for _, p in emptied], dtype=torch.long)
    moved = torch.zeros(c["xs"].shape[0], c["xs"].shape[2], dtype=torch.bool)
    moved[ro, po] = True
    moved[rn, pn] = True
    keep = ~moved[:, None, :]
    for key, src, fill in (("xs", None, 1e18), ("x0s", None, 1e18),
                           ("vs", "vs", 0.0), ("acc", "acc", 0.0),
                           ("rp", "rp", 0.0), ("movb", None, False)):
        a, b = out[key], c[key]
        assert torch.equal(torch.where(keep, a, 0), torch.where(keep, b, 0))
        if key == "movb":
            assert bool(a[rn, 0, pn].all())
        elif src is None:
            assert _equal(a[rn, :, pn], x_m)
        else:
            assert _equal(a[rn, :, pn], b[ro, :, po])
        assert bool((a[er, :, ep] == fill).all()), key
    for key, src in (("xs", None), ("vs", "vs"), ("acc", "acc")):
        a = getattr(o2, key)
        assert torch.equal(torch.where(keep, a, 0),
                           torch.where(keep, getattr(other, key), 0))
        want = x_m if src is None else c[src][ro, :, po]
        assert _equal(a[rn, :, pn], want), key
    addr0, addr = c["addr"], out["addr"]
    assert torch.equal(addr.pos[pids].long(), pn)
    assert torch.equal(addr.row_pos[pids].long(), rn)
    rest = torch.ones(addr.pos.shape[0], dtype=torch.bool)
    rest[pids] = False
    assert torch.equal(addr.pos[rest], addr0.pos[rest])
    assert torch.equal(addr.row_pos[rest], addr0.row_pos[rest])
    dg = np.zeros(addr0.gcounts.numel(), np.int64)
    np.add.at(dg, (rn * sg.n_groups + pn // 128).numpy(), 1)
    np.add.at(dg, (ro * sg.n_groups + po // 128).numpy(), -1)
    assert np.array_equal(
        (addr.gcounts.long() - addr0.gcounts.long()).reshape(-1).numpy(), dg)
    want_x = x0.clone()
    want_x[pids] = x_m
    assert _equal(out["anchors"], want_x)


@pytest.mark.parametrize("name", sorted(PLACED))
@pytest.mark.parametrize("cap", [8, 16])
@pytest.mark.parametrize("dim", [2, 3])
def test_cpu_tensors_run_the_plain_sequence(dim, cap, name):
    """On CPU tensors the wrappers launch nothing; each carry reaches the
    branch it names (its risky count, movers, lanes), and where it can
    repair, the apply moves exactly the movers' slots (`_check_moved`),
    the other storage and the anchors included."""
    grid, sg, c, x0, mv, other, repair_k, can = placed(dim, cap, name)
    act = torch.ones(x0.shape[0], dtype=torch.bool)
    repair.reset_launches()
    plan, apply = _tools(grid, sg, dim, repair_k)
    got = plan(c, x0, act, act)
    assert sorted(got) == sorted(PLAN_KEYS)
    assert bool(got["can"]) == can
    assert int(got["n_risky"]) == len(mv)
    taken = min(len(mv), repair_k)
    assert torch.equal(got["pids"][:taken], mv[:taken])
    assert int(got["vm"].sum()) == taken
    lanes = (got["new_pos"] % cap)[:taken].tolist()
    if name == "several_into_one":
        assert lanes == [1, 2, 3]
    elif name == "same_cell_rehome":
        assert torch.equal(got["new_pos"][:1], got["old_pos"][:1])
    elif name == "to_row_0":
        assert int(got["new_row"][0]) == 0
    if can:
        c2, o2 = clone(c, other)
        out = apply(c2, got, [o2], anchors=x0)
        _check_moved(c, other, got, out, o2, x0, sg)
    assert all(n == 0 for n in repair.LAUNCHES.values())


@pytest.mark.parametrize("dim", [2, 3])
def test_apply_anchors_are_the_advance_patch(dim):
    """`anchors=` returns the shadow's x advanced to x_m at the repaired
    pids, as the advance's own patch did (`torch.cat` + `index_put_` +
    slice), and the same carry and addressing as without it."""
    grid, sg, c, x0, mv, other, repair_k, _ = placed(dim, 16,
                                                      "several_into_one")
    act = torch.ones(x0.shape[0], dtype=torch.bool)
    plan, apply = _tools(grid, sg, dim, repair_k)
    pl = plan(c, x0, act, act)
    c_a, _ = clone(c, other)
    c_b, _ = clone(c, other)
    a = apply(c_a, pl, anchors=x0)
    b = apply(c_b, pl)
    n = x0.shape[0]
    sidx = torch.where(pl["vm"], pl["pids"], n)
    x_ext = torch.cat([x0, x0.new_zeros((1, dim))])
    x_ext.index_put_((sidx,), pl["x_m"])
    assert _equal(a["anchors"], x_ext[:n])
    assert not torch.equal(a["anchors"][mv], x0[mv])
    assert "anchors" not in b
    for k in ("xs", "vs", "acc", "x0s", "rp", "movb"):
        assert _equal(a[k], b[k]), k
    for k in ("pos", "row_pos", "gcounts"):
        assert _equal(getattr(a["addr"], k), getattr(b["addr"], k)), k


@pytest.mark.parametrize("repair_k", [8, 4096])
@pytest.mark.parametrize("dim", [2, 3])
def test_cpu_cloud_runs_the_plain_sequence(dim, repair_k):
    """A random cloud with risky particles in many particle blocks, fewer
    and more than repair_k: the movers are the first risky particles in
    ascending order, each movable, with its slot's x; where the plan can
    repair, each mover lands in a distinct slot of its target cell that
    was empty or that a mover left, and the apply moves exactly those
    slots."""
    grid, sg, c, x0, act, mov, other = cloud(dim, 16, 3000, seed=5 + dim)
    plan, apply = repair.make_repair_tools(
        grid=grid, sg=sg, d=dim, dt=0.01, sort_every=4, budget=2.0,
        repair_k=repair_k, gather=GATHER)
    got = plan(c, x0, act, mov)
    n_risky = int(got["n_risky"])
    assert n_risky > 8 and (n_risky > repair_k) == (repair_k == 8)
    assert bool(got["can"]) == (repair_k != 8)
    taken = min(n_risky, repair_k)
    vm, pids = got["vm"], got["pids"]
    assert bool(vm[:taken].all()) and not bool(vm[taken:].any())
    assert bool((pids[taken:] == x0.shape[0]).all())
    pm = pids[:taken]
    assert bool((pm[1:] > pm[:-1]).all()) and bool(mov[pm].all())
    ro, po = got["old_row"][:taken].long(), got["old_pos"][:taken].long()
    assert _equal(got["x_m"][:taken], c["xs"][ro, :, po])
    if not bool(got["can"]):
        return
    rn, pn = got["new_row"][:taken].long(), got["new_pos"][:taken].long()
    ci, _ = neighbors.cell_index(got["x_m"][:taken], vm[:taken], grid)
    code = ((ci[:, 0] + 1) * sg.h1 + ci[:, 1] + 1 if dim == 3
            else ci[:, 0] + 1)
    assert bool((rn > 0).all())
    assert torch.equal(c["addr"].row_code[rn].long(), code.long())
    assert torch.equal(pn // sg.cap, (ci[:, -1] + sg.xc).long())
    slots = rn * sg.lanes + pn
    assert torch.unique(slots).numel() == taken
    left = set((ro * sg.lanes + po).tolist())
    empty = c["xs"][rn, 0, pn] >= 1e17
    assert all(bool(e) or int(s) in left for e, s in zip(empty, slots))
    c2, o2 = clone(c, other)
    _check_moved(c, other, got, apply(c2, got, [o2], anchors=x0), o2, x0,
                 sg)


@pytest.mark.parametrize("slab_name", sorted(SLABS))
@pytest.mark.parametrize("dim", [2, 3])
def test_slab_calls_take_the_plain_path(dim, slab_name):
    """A slab's call on CPU tensors (its lattice's index offset, its faces
    and band) is the plain plan with the face test the slab advance built
    itself: the distance to the nearer interior face, and as `allowed` the
    particles whose anchors lie in neither band.  On the shifted lattice
    the plan finds the movers, slots and lanes of the unshifted one; a
    mover whose anchor lies in a band vetoes the repair; nothing
    launches."""
    ci_off, faces, band = slab(dim, slab_name)
    grid, sg, c, x0, mv, _, repair_k, _ = placed(dim, 16, "several_into_one",
                                                 ci_off=ci_off)
    act = torch.ones(x0.shape[0], dtype=torch.bool)
    repair.reset_launches()
    plan, _ = _tools(grid, sg, dim, repair_k, ci_off=ci_off, faces=faces,
                     band=band)
    got = plan(c, x0, act, act)
    near_lo, near_hi = faces.bands(x0, band)
    interior = ~(near_lo | near_hi)
    want = _tools(grid, sg, dim, repair_k, plain=True, ci_off=ci_off)[0](
        c, x0, act, act, face_fn=lambda x_now: (
            faces.face_margin(x_now[:, faces.axis]), interior))
    for k in PLAN_KEYS:
        assert _equal(got[k], want[k]), k
    assert all(n == 0 for n in repair.LAUNCHES.values())
    grid1, sg1, c1, x1, _, _, _, _ = placed(dim, 16, "several_into_one")
    one = _tools(grid1, sg1, dim, repair_k)[0](c1, x1, act, act)
    for k in ("n_risky", "pids", "vm", "old_row", "old_pos", "new_row",
              "new_pos"):
        assert _equal(got[k], one[k]), k
    assert bool(got["can"]) == (slab_name != "veto")
    assert bool(interior[mv].all()) == (slab_name != "veto")


@pytest.mark.parametrize("dim", [2, 3])
def test_tools_take_strided_anchors(dim):
    """Anchors in column order, as a state loaded from a checkpoint holds
    its x: the plan and the apply (its patched anchors contiguous) give
    what contiguous anchors give."""
    grid, sg, c, x0, _, other, repair_k, _ = placed(dim, 16,
                                                     "several_into_one")
    act = torch.ones(x0.shape[0], dtype=torch.bool)
    x0_t = x0.T.contiguous().T
    assert not x0_t.is_contiguous() and torch.equal(x0_t, x0)
    plan, apply = _tools(grid, sg, dim, repair_k)
    got, want = plan(c, x0_t, act, act), plan(c, x0, act, act)
    for k in PLAN_KEYS:
        assert _equal(got[k], want[k]), k
    outs = []
    for a in (x0_t, x0):
        c2, o2 = clone(c, other)
        outs.append(apply(c2, got, [o2], anchors=a))
    assert outs[0]["anchors"].is_contiguous()
    assert _equal(outs[0]["anchors"], outs[1]["anchors"])


def _bad_plan_inputs(case, c, x0, act):
    """(c, x0, act, movable) with one input the plan kernels refuse."""
    c = dict(c)
    mov = act
    if case == "xs_float64":
        c["xs"] = c["xs"].double()
    elif case == "vs_lanes":
        c["vs"] = c["vs"][:, :, :-128]
    elif case == "vs_strided_lanes":
        c["vs"] = c["vs"].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "x0_longer_than_addr":
        x0 = torch.cat([x0, x0])
        act = mov = torch.ones(x0.shape[0], dtype=torch.bool)
    elif case == "movable_int":
        mov = act.to(torch.int32)
    elif case == "act_short":
        act = act[:-1]
    return c, x0, act, mov


PLAN_REFUSALS = {"xs_float64": TypeError, "vs_lanes": ValueError,
                 "vs_strided_lanes": ValueError,
                 "x0_longer_than_addr": ValueError,
                 "movable_int": TypeError, "act_short": ValueError}


@pytest.mark.parametrize("case", sorted(PLAN_REFUSALS))
def test_plan_rejects_what_the_kernels_do_not_take(case):
    grid, sg, c, x0, _, _, repair_k, _ = placed(3, 16, "several_into_one")
    act = torch.ones(x0.shape[0], dtype=torch.bool)
    plan, _ = _tools(grid, sg, 3, repair_k)
    with pytest.raises(PLAN_REFUSALS[case]):
        plan(*_bad_plan_inputs(case, c, x0, act))


APPLY_REFUSALS = {"acc_float64": TypeError, "rp_shape": ValueError,
                  "movb_float": TypeError, "pids_int32": TypeError,
                  "x_m_shape": ValueError, "three_storages": ValueError,
                  "anchors_float64": TypeError,
                  "other_vs_shape": ValueError}


@pytest.mark.parametrize("case", sorted(APPLY_REFUSALS))
def test_apply_rejects_what_the_kernels_do_not_take(case):
    grid, sg, c, x0, _, other, repair_k, _ = placed(2, 8, "swap_full_cells")
    act = torch.ones(x0.shape[0], dtype=torch.bool)
    plan, apply = _tools(grid, sg, 2, repair_k)
    pl = dict(plan(c, x0, act, act))
    c = dict(c)
    also, anchors = [other], x0
    if case == "acc_float64":
        c["acc"] = c["acc"].double()
    elif case == "rp_shape":
        c["rp"] = c["rp"][:, :1]
    elif case == "movb_float":
        c["movb"] = c["movb"].float()
    elif case == "pids_int32":
        pl["pids"] = pl["pids"].int()
    elif case == "x_m_shape":
        pl["x_m"] = pl["x_m"][:-1]
    elif case == "three_storages":
        also = [other] * 3
    elif case == "anchors_float64":
        anchors = x0.double()
    elif case == "other_vs_shape":
        other = copy.copy(other)
        other.d = 3
        also = [other]
    with pytest.raises(APPLY_REFUSALS[case]):
        apply(c, pl, also, anchors=anchors)
