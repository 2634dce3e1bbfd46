"""The resident block's slot-space passes (`sph_tpu_torch.slot_pass`):
`slot_pre` (kick, drift, features) and `slot_post` (body forces,
integration, clamp walls, drift audit with membership).

- Their plain versions against the reference's own slot-space arithmetic
  (`sph_tpu.step._SlotPhysics.body_forces`, `clamp_slot`,
  `mk_feat_builder`, `_membership_bad`, in `run_block`'s kick / drift /
  audit order, sph_tpu/step.py:1032-1093) on the same arrays: floats within
  rtol 1e-5, atol 1e-6 (tests/test_pallas_equiv.py:55), the violation count
  exactly.
- `step._slot_steps`, which drives them on a fresh block with in-place
  updates over the occupied groups only, bitwise the sequence it replaced
  (`_pre_pr_slot_steps` below, frozen) over whole slot arrays, the slab
  hooks included, and the carry it started from left unchanged.
- On a card (tests marked `gpu`, skipped here): each kernel bitwise its
  plain version, and `_slot_steps` bitwise the frozen sequence run by
  PyTorch on the card.

The reference is imported inside the tests that use it, so the `gpu`
cases also run where JAX is not installed:

    python -m pytest tests/test_torch_slot_pass.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

import sph_tpu_torch as port
from sph_tpu_torch import decomp as tdc
from sph_tpu_torch import neighbors as tnb
from sph_tpu_torch import pallas_step as tps
from sph_tpu_torch import slot_pass
from sph_tpu_torch import step as port_step
from sph_tpu_torch.params import Block, ForceField

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


# ---------------------------------------------------------------------------
# The sequence `_slot_steps` ran before the kernels, kept as it was
# ---------------------------------------------------------------------------


def _pre_pr_mk_feat(sp, c):
    if sp.params.precision == "bf16":
        sg, d = sp.sg, sp.d
        dev = c["addr"].row_code.device
        centers = sp.slot_centers(c["addr"])
        zrow = torch.zeros((sg.c_rows, 3 - d, sg.lanes), device=dev)
        z2 = torch.zeros((sg.c_rows, 2, sg.lanes), device=dev)

        def mk_feat(xs_, vs_):
            return torch.cat([xs_ - centers, zrow, vs_, zrow, z2],
                             dim=1).to(torch.bfloat16)

        return mk_feat
    mov = c["movb"].to(torch.float32)
    tail = torch.cat([mov, torch.zeros_like(mov)], dim=1)
    zrow = torch.zeros((sp.sg.c_rows, 3 - sp.d, sp.sg.lanes),
                       device=mov.device)

    def mk_feat(xs_, vs_):
        return torch.cat([xs_, zrow, vs_, zrow, tail], dim=1)

    return mk_feat


def _pre_pr_slot_steps(sp, c, sort_every, half2, use_mem, grid, leap,
                       exchange=None, rp_hook=None, ci_offset=None,
                       beyond=None):
    mk_feat = _pre_pr_mk_feat(sp, c)
    params, d = sp.params, sp.d
    dt = params.dt
    addr, sg, movb = c["addr"], sp.sg, c["movb"]
    mov = movb.to(torch.float32)
    xs, vs, acc_s, x0s = c["xs"], c["vs"], c["acc"], c["x0s"]
    step0 = c["step0"]
    jb = c["jb"]
    viol = None
    for i in range(sort_every):
        if i or not c.get("drifted"):
            if leap:
                if acc_s is not None:
                    vs = vs + (0.5 * dt) * acc_s * mov
                xs = xs + dt * vs * mov
            if exchange is not None:
                if i == 0 and not leap:
                    xs, vs = xs.clone(), vs.clone()
                exchange(xs, vs)
        feat = mk_feat(xs, vs)
        rp = tps._call_density(feat, addr, sg, params, jb)
        if rp_hook is not None:
            rp_hook(rp)
        f_s = tps._call_force(feat, rp, addr, sg, params, jb)
        rho_s = rp[:, 0:1, :]
        f_tot = sp.body_forces(xs, vs, rho_s, f_s[:, 0:d, :], step0, i)
        a_s = torch.where(movb, f_tot / torch.clamp(rho_s, min=1e-12), 0.0)
        if leap:
            vs = vs + (0.5 * dt) * a_s
        else:
            vs = vs + dt * a_s * mov
            xs = xs + dt * vs * mov
        acc_s = a_s
        if params.boundary_mode == "clamp":
            xs, vs = sp.clamp_slot(xs, vs, movb)
        dd = xs - x0s
        drift2 = torch.sum(dd * dd, dim=1, keepdim=True)
        bad_i = (drift2 > half2) & movb
        if use_mem:
            bad_i = slot_pass.membership_bad(
                bad_i, xs, c["refs"], grid, ci_offset,
                None if beyond is None else beyond(xs))
        n_bad = torch.sum(bad_i, dtype=torch.int32)
        viol = n_bad if viol is None else viol + n_bad
    return xs, vs, acc_s, rp, viol


# ---------------------------------------------------------------------------
# Carries
# ---------------------------------------------------------------------------

FIELD_ON = ForceField(pos=(150.0, 120.0, 150.0), strength=4e4, radius=90.0,
                      start_step=0, stop_step=1 << 30)
FIELD_OFF = ForceField(pos=(150.0, 120.0, 150.0), strength=-4e4,
                       radius=90.0, start_step=500, stop_step=900)
# a radius whose fp32 reciprocal rounded from double is not that of
# fp32(radius): PyTorch's CUDA division by a Python float would multiply
# by the former (fuzz seed 31's field, tests/torch_fuzz_scenes.py)
FIELD_ODD = ForceField(pos=(60.0, 40.0, 40.0), strength=2.05e4,
                       radius=34.458634852238134)


def _scene(dim, leap, penalty, fields=(), bf16=False):
    """A small calibrated dam with a fast block and a static boundary
    block (real slots that do not move)."""
    kw = dict(integrator="leapfrog" if leap else "euler",
              boundary_mode="penalty" if penalty else "clamp",
              precision="bf16" if bf16 else "fp32")
    if dim == 3:
        kw.update(dim=3, gravity=(0.0, -9.81, 0.0), eos="tait",
                  kernel_norm="proper", dt=4e-4)
    p = port.SimParams(**kw)
    e = p.wall_eps
    top = 90.0 if dim == 2 else 50.0
    blocks = [Block(lo=(e + 2,) * dim, hi=(e + top,) * dim),
              Block(lo=(e + 110,) + (e + 2,) * (dim - 1),
                    hi=(e + 140,) + (e + 30,) * (dim - 1),
                    velocity=(900.0,) + (0.0,) * (dim - 1)),
              Block(lo=(e + 145,) + (e + 2,) * (dim - 1),
                    hi=(e + 165,) + (e + 12,) * (dim - 1), kind=1)]
    ff = tuple(f.__class__(pos=f.pos[:dim], strength=f.strength,
                           radius=f.radius, start_step=f.start_step,
                           stop_step=f.stop_step) for f in fields)
    scene = port.Scene(params=p, lo=(0.0,) * dim, hi=(200.0,) * dim,
                       blocks=tuple(blocks), force_fields=ff, seed=3)
    return port.calibrate(scene)


def _carry(scene, packed=False, dev="cpu", acc=True, holes=0, steps=0):
    """A resident block's carry of `scene` (run `steps` steps first) on its
    sort_every=4 lattice: `_residency` as the resident advances build it,
    an acc of the size of the forces (None: a fresh classic carry), and
    with `holes` live slots emptied as a repair leaves them."""
    p = scene.params
    st = port.init(scene, device=dev)
    if steps:
        st = port.run(scene, steps, method="naive", state=st, device=dev)
    grid = tnb.GridSpec.for_scene(
        scene, cap=tnb.GridSpec.for_scene(scene).cap,
        skin=port.default_skin(scene, 4))
    sg = tps.packed_grid(grid) if packed else tps.slot_grid(grid)
    leap = p.integrator == "leapfrog"
    c = port_step._residency(st, grid, sg, p.dim, p.dt, leap, True)
    if holes:
        real = (c["xs"][:, 0, :] < 1e17).nonzero()
        for row, lane in real[torch.randperm(real.shape[0],
                                             generator=torch.Generator()
                                             .manual_seed(holes))[:holes]]:
            c["xs"][row, :, lane] = 1e18
            c["vs"][row, :, lane] = 0.0
            c["movb"][row, :, lane] = False
    if acc:
        rng = np.random.default_rng(7)
        a = rng.normal(0.0, 3e3, c["xs"].shape).astype(np.float32)
        c["acc"] = torch.where(c["movb"], torch.from_numpy(a).to(dev), 0.0)
    else:
        c["acc"] = None
    sp = port_step._SlotPhysics(scene, grid, sg, torch.device(dev))
    return sp, grid, c


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4
                               else torch.int16)


def _bitwise(a, b) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _snapshot(c):
    return {k: c[k].clone() for k in ("xs", "vs", "x0s", "movb")
            if c.get(k) is not None}


CASES = {
    # dim, leap, penalty, fields, bf16, packed, acc, half2 scale
    "2d-euler-clamp": (2, False, False, (), False, False, False, 1.0),
    "2d-euler-clamp-fields-tiny-skin": (2, False, False,
                                        (FIELD_ON, FIELD_OFF), False, False,
                                        False, 1e-4),
    "2d-leap-penalty-bf16": (2, True, True, (FIELD_ON,), True, False, True,
                             1e-3),
    "3d-leap-penalty": (3, True, True, (), False, False, True, 1.0),
    "3d-leap-penalty-fields-tiny-skin": (3, True, True, (FIELD_ON, FIELD_OFF),
                                         False, False, True, 1e-4),
    "3d-leap-clamp-no-acc": (3, True, False, (), False, False, False, 1e-3),
    "3d-euler-penalty-bf16": (3, False, True, (), True, False, False, 1e-3),
    "3d-leap-packed": (3, True, True, (FIELD_ON,), False, True, True, 1e-3),
    "3d-euler-clamp-field-odd-radius": (3, False, False, (FIELD_ODD,), False,
                                        False, False, 1e-3),
}


def _case(name, dev="cpu"):
    dim, leap, penalty, fields, bf16, packed, acc, scale = CASES[name]
    scene = _scene(dim, leap, penalty, fields, bf16)
    sp, grid, c = _carry(scene, packed, dev, acc, holes=5, steps=3)
    skin = port.default_skin(scene, 4)
    return sp, grid, c, leap, scale * (0.5 * skin) ** 2


def _equal_runs(sp, grid, c, leap, half2, budget=None, **hooks):
    """The new `_slot_steps` and the frozen sequence from the same carry:
    whole arrays bitwise, the count equal, the carry untouched; with a
    `budget`, the rebuild predicate's slots the last slot_post counts
    equal to `_membership_risky` on the frozen sequence's end (the slab's
    face distance its extra margin), as `need_of` computed it."""
    before = _snapshot(c)
    new_kw = hooks.get("new", {})
    new = port_step._slot_steps(sp, c, 4, half2, True, leap, budget=budget,
                                **new_kw)
    old = _pre_pr_slot_steps(sp, c, 4, half2, True, grid, leap,
                             **hooks.get("old", {}))
    for k, (a, b) in enumerate(zip(new[:4], old[:4])):
        assert _bitwise(a, b), ("xs", "vs", "acc", "rp")[k]
    assert int(new[4]) == int(old[4])
    for k, t in before.items():
        assert _bitwise(c[k], t), f"the carry's {k} was written"
    if budget is None:
        assert new[5] is None
        return int(new[4]), None
    dd = old[0] - c["x0s"]
    dd2 = torch.sum(dd * dd, dim=1, keepdim=True)
    faces = new_kw.get("faces")
    risky = slot_pass.membership_risky(
        dict(xs=old[0], vs=old[1], refs=c["refs"], movb=c["movb"]), grid,
        dd2, sp.params.dt, 4, budget, new_kw.get("ci_offset"),
        None if faces is None else slot_pass.face_margin(faces, old[0]))
    assert int(new[5]) == int(risky.sum())
    return int(new[4]), int(new[5])


@pytest.mark.parametrize("name", list(CASES))
def test_slot_steps_bitwise_the_replaced_sequence(name):
    """Skipping empty groups, updating in place and the fresh block storage
    change no bit of xs, vs, acc or rp, nor the counts (a zero budget: the
    rebuild predicate is decided by the membership side)."""
    sp, grid, c, leap, half2 = _case(name)
    _equal_runs(sp, grid, c, leap, half2, budget=0.0)


@pytest.mark.parametrize("drifted", [False, True], ids=["plain", "drifted"])
@pytest.mark.parametrize("dim", [2, 3])
def test_slot_steps_with_slab_hooks_bitwise(dim, drifted):
    """The slab's hooks in their places: an exchange that writes slots in
    place after the drift (into the array K1 reads: it changes rp), an
    rp hook between K1 and K2, a `ci_offset` and faces past which the
    audit stays strict."""
    leap = dim == 3
    scene = _scene(dim, leap, leap, (FIELD_ON,))
    sp, grid, c = _carry(scene, acc=True, steps=3)
    c["drifted"] = drifted
    real = (c["xs"][:, 0, :] < 1e17).nonzero()
    ghost = real[::7]                         # slots the "exchange" rewrites
    rows, lanes = ghost[:, 0], ghost[:, 1]
    k = torch.arange(rows.shape[0], dtype=torch.float32)[:, None]

    def exchange(xs, vs):
        xs[rows, :, lanes] = xs[rows, :, lanes] + 0.25 + 0.001 * k
        vs[rows, :, lanes] = -vs[rows, :, lanes]

    def rp_hook(rp):
        rp[rows, 1, lanes] = rp[rows, 1, lanes] * 1.5

    axis = dim - 1
    off = (0,) * dim
    faces = tdc._Slab(axis=axis, first=False, last=True, lo=60.0, hi=90.0,
                      ci_off=off)
    half2 = 1e-3 * (0.5 * port.default_skin(scene, 4)) ** 2
    n, risky = _equal_runs(
        sp, grid, c, leap, half2, budget=0.0,
        new=dict(exchange=exchange, rp_hook=rp_hook, ci_offset=off,
                 faces=faces),
        old=dict(exchange=exchange, rp_hook=rp_hook, ci_offset=off,
                 beyond=lambda xs: slot_pass.face_beyond(faces, xs)))
    assert n > 0 and risky > 0


def test_slot_steps_rejects_bf16_with_slab_hooks():
    scene = _scene(2, False, False, bf16=True)
    sp, grid, c = _carry(scene, acc=False)
    with pytest.raises(ValueError, match="fp32"):
        port_step._slot_steps(sp, c, 4, 1.0, True, False,
                              exchange=lambda xs, vs: None)


def test_visit_covers_every_movable_slot():
    """What the kernels skip holds no movable and no real slot: the
    occupied groups of rows 1..n_occ cover them all."""
    sp, grid, c, _, _ = _case("3d-leap-penalty")
    addr = c["addr"]
    visit = slot_pass._visit(addr.gcounts, addr.n_occ, sp.sg.lanes)
    assert not bool((c["movb"] & ~visit).any())
    assert not bool(((c["xs"][:, 0:1, :] < 1e17) & ~visit).any())
    assert bool(visit.any()) and not bool(visit.all())


@pytest.mark.parametrize("name", ["3d-leap-penalty", "3d-leap-packed",
                                  "2d-euler-clamp"])
def test_occupied_tiles_list_the_visited_groups(name):
    """The tile list the kernels walk: the occupied (row, group) tiles of
    rows 1..n_occ in row-major order, their count on the device, and
    their lanes exactly the slots the plain versions visit."""
    sp, grid, c, _, _ = _case(name)
    addr, sg = c["addr"], sp.sg
    tiles, n_tiles = slot_pass.occupied_tiles(addr.gcounts, addr.n_occ)
    n = int(n_tiles[0])
    assert tiles.dtype == n_tiles.dtype == torch.int32
    assert tiles.shape == (sg.c_rows * sg.n_groups,) and n_tiles.shape == (1,)
    got = tiles[:n].long()
    assert bool((got[1:] > got[:-1]).all())
    mask = torch.zeros(sg.c_rows * sg.n_groups, dtype=torch.bool)
    mask[got] = True
    lanes = mask.reshape(sg.c_rows, sg.n_groups).repeat_interleave(
        slot_pass.LANE, dim=1)[:, None, :]
    assert torch.equal(lanes, slot_pass._visit(addr.gcounts, addr.n_occ,
                                               sg.lanes))
    assert 0 < n < sg.c_rows * sg.n_groups


def test_wrappers_reject_arrays_the_kernels_do_not_take():
    sp, grid, c, leap, half2 = _case("3d-leap-penalty")
    addr, sg = c["addr"], sp.sg
    blk = slot_pass.SlotBlock(sg.c_rows, sg.lanes, 3, False, "cpu")
    args = (c["movb"], addr.gcounts, addr.n_occ, 1e-3)
    with pytest.raises(TypeError):
        slot_pass.slot_pre(blk, c["xs"].double(), c["vs"], c["acc"], *args,
                           True, True, True)
    with pytest.raises(ValueError):
        slot_pass.slot_pre(blk, c["xs"].transpose(0, 2), c["vs"], c["acc"],
                           *args, True, True, True)
    with pytest.raises(ValueError):
        slot_pass.slot_pre(blk, c["xs"], c["vs"], c["acc"][:, :2], *args,
                           True, True, True)
    plan = slot_pass.PostPlan(sp, leap, half2, True)
    rp = torch.zeros((sg.c_rows, 2, sg.lanes))
    with pytest.raises(ValueError):
        slot_pass.slot_post(blk, rp, rp, c["x0s"], c["movb"], addr, plan,
                            c["step0"], 0)


# ---------------------------------------------------------------------------
# The plain versions against the reference's slot-space arithmetic
# ---------------------------------------------------------------------------


def _ref_side(scene, packed, x, v, active):
    """The reference's scene, grid, sg, addr and scattered feat of the
    same cloud (kind from `active`: 1 static, 2 inactive)."""
    import jax.numpy as jnp
    import sph_tpu
    from sph_tpu import neighbors as jnb
    from sph_tpu import pallas_step as jps

    ref_scene = sph_tpu.scene_from_json(port.scene_to_json(scene))
    skin = port.default_skin(scene, 4)
    rg = jnb.GridSpec.for_scene(
        ref_scene, cap=jnb.GridSpec.for_scene(ref_scene).cap, skin=skin)
    rsg = jps.packed_grid(rg) if packed else jps.slot_grid(rg)
    raddr = jps.build_addr(jnp.asarray(x), jnp.asarray(active), rg, rsg)
    return ref_scene, rg, rsg, raddr


def _ref_step(ref_scene, rg, rsg, raddr, arrs, leap, half2, use_mem, step_i,
              first_kick, budget):
    """One step of `run_block` (sph_tpu/step.py:1048-1092) on the arrays,
    with K1/K2's outputs given: feat, xs, vs, acc, the count, and the
    rebuild predicate's slots on the result (`_membership_risky` for a
    next block of 4 steps)."""
    import jax.numpy as jnp
    from sph_tpu import step as ref_step

    p = ref_scene.params
    dt, d = p.dt, p.dim
    sp = ref_step._SlotPhysics(ref_scene, rg, rsg)
    xs, vs, acc, x0s, movb, feat0, rp, f = (jnp.asarray(arrs[k]) for k in (
        "xs", "vs", "acc", "x0s", "movb", "feat0", "rp", "f"))
    mov = movb.astype(jnp.float32)
    mk_feat = sp.mk_feat_builder(raddr, feat0)
    if leap:
        if first_kick:
            vs = vs + (0.5 * dt) * acc * mov
        xs = xs + dt * vs * mov
    feat = mk_feat(xs, vs)
    rho_s = rp[:, 0:1, :]
    f_tot = sp.body_forces(xs, vs, rho_s, f[:, 0:d, :], step_i)
    a_s = jnp.where(movb, f_tot / jnp.maximum(rho_s, 1e-12), 0.0)
    if leap:
        vs = vs + (0.5 * dt) * a_s
    else:
        vs = vs + dt * a_s * mov
        xs = xs + dt * vs * mov
    if p.boundary_mode == "clamp":
        xs, vs = sp.clamp_slot(xs, vs, movb)
    dd = xs - x0s
    drift2 = jnp.sum(dd * dd, axis=1, keepdims=True)
    bad = (drift2 > half2) & movb
    if use_mem:
        bad = ref_step._membership_bad(bad, xs, raddr, rsg, rg)
    risky = ref_step._membership_risky(dict(xs=xs, vs=vs, movb=movb), raddr,
                                       rsg, rg, drift2, dt, 4, budget)
    return {k: np.asarray(val, np.float32) for k, val in (
        ("feat", feat), ("xs", xs), ("vs", vs), ("acc", a_s))}, \
        int(bad.sum()), int(risky.sum())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_passes_match_reference(name):
    """One step: `slot_pre` then `slot_post` (plain, on the CPU) against
    the reference's block body on the same slot arrays, with the same K1/K2
    outputs; the audit at a skin small enough that it fires and membership
    decides, and the rebuild predicate the block's last slot_post counts
    against the reference's `_membership_risky`."""
    import jax.numpy as jnp
    from sph_tpu import pallas_step as jps

    dim, leap, penalty, fields, bf16, packed, acc_on, _ = CASES[name]
    scene = _scene(dim, leap, penalty, fields, bf16)
    p = scene.params
    st = port.run(scene, 3, method="naive",
                  state=port.init(scene, device="cpu"), device="cpu")
    x, v = st.x.numpy(), st.v.numpy()
    active = st.active.numpy()
    movable = active & (st.kind.numpy() == 0)
    ref_scene, rg, rsg, raddr = _ref_side(scene, packed, x, v, active)
    tg = tnb.GridSpec.for_scene(scene, cap=tnb.GridSpec.for_scene(scene).cap,
                                skin=port.default_skin(scene, 4))
    tsg = tps.packed_grid(tg) if packed else tps.slot_grid(tg)
    taddr = tps.build_addr(st.x, st.active, tg, tsg)
    n = x.shape[0]
    z = np.zeros((n, 3 - dim), np.float32)
    rows = np.concatenate([x, z, v, z, movable[:, None].astype(np.float32)],
                          axis=1)
    feat0 = np.array(jps.scatter_slots(raddr, jnp.asarray(rows), rsg))
    tfeat0 = tps.scatter_slots(taddr, torch.from_numpy(rows), tsg)
    assert np.array_equal(feat0, tfeat0.numpy())
    rng = np.random.default_rng(dim * 10 + len(name))
    shape = feat0[:, 0:dim, :].shape
    real = feat0[:, 0:1, :] < 1e17
    movb = feat0[:, 6:7, :] > 0
    x0s = feat0[:, 0:dim, :]
    # moves of ~0.15 cell: some slots leave their build cells
    xs = np.where(movb, x0s + rng.normal(0.0, 0.15 * tg.cell, shape)
                  .astype(np.float32), x0s)
    acc = np.where(movb, rng.normal(0.0, 3e3, shape), 0.0).astype(np.float32)
    rp = np.where(real, np.stack([rng.uniform(900, 1100, real.shape[::2]),
                                  rng.uniform(-50, 500, real.shape[::2])],
                                 axis=1).astype(np.float32), 0.0)
    f = np.zeros((feat0.shape[0], 4, feat0.shape[2]), np.float32)
    f[:, 0:dim] = np.where(real, rng.normal(0.0, 2e5, shape), 0.0)
    arrs = dict(xs=xs, vs=feat0[:, 3:3 + dim, :], acc=acc, x0s=x0s,
                movb=movb, feat0=feat0, rp=rp, f=f)
    skin = port.default_skin(scene, 4)
    half2 = (0.02 * skin) ** 2
    step_i = 600                      # FIELD_OFF's window is 500..900
    budget = 0.25 * skin
    ref, ref_bad, ref_risky = _ref_step(ref_scene, rg, rsg, raddr, arrs, leap,
                                        half2, True, step_i, acc_on, budget)

    t = {k: torch.from_numpy(np.ascontiguousarray(a))
         for k, a in arrs.items()}
    sp = port_step._SlotPhysics(scene, tg, tsg, torch.device("cpu"))
    blk = slot_pass.SlotBlock(tsg.c_rows, tsg.lanes, dim, bf16, "cpu")
    centers = sp.slot_centers(taddr) if bf16 else None
    slot_pass.slot_pre(blk, t["xs"], t["vs"], t["acc"], t["movb"],
                       taddr.gcounts, taddr.n_occ, p.dt, leap and acc_on,
                       leap, True, centers)
    feat = (blk.feat16 if bf16 else blk.feat).float().numpy()
    np.testing.assert_allclose(feat, ref["feat"], rtol=RTOL, atol=ATOL)
    plan = slot_pass.PostPlan(sp, leap, half2, True, budget=budget,
                              sort_every=4)
    slot_pass.slot_post(blk, t["rp"], t["f"], t["x0s"], t["movb"], taddr,
                        plan, torch.tensor(step_i - 1, dtype=torch.int32), 1,
                        last=True)
    for k, got in (("xs", blk.xs), ("vs", blk.vs), ("acc", blk.acc)):
        np.testing.assert_allclose(got.numpy(), ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert int(blk.count) == ref_bad
    assert 0 < ref_bad < int(movb.sum())
    assert int(blk.risky) == ref_risky
    assert 0 < ref_risky < int(movb.sum())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_bitwise_plain_versions_on_card(name):
    """slot_pre (first and in place) and slot_post against their plain
    versions on the same CUDA arrays: every element bitwise, the audit's
    count and (at the last step) the rebuild predicate's equal, one launch
    each counted."""
    dev = _card()
    sp, grid, c, leap, half2 = _case(name, dev="cuda")
    addr, sg, d = c["addr"], sp.sg, sp.d
    bf16 = sp.params.precision == "bf16"
    centers = sp.slot_centers(addr) if bf16 else None
    plan = slot_pass.PostPlan(sp, leap, half2, True, budget=0.0,
                              sort_every=4)
    blocks = [slot_pass.SlotBlock(sg.c_rows, sg.lanes, d, bf16, dev)
              for _ in range(2)]
    acc0 = c["acc"]
    for i in range(3):
        before = dict(slot_pass.LAUNCHES)
        for blk, pre, post in ((blocks[0], slot_pass.slot_pre,
                                slot_pass.slot_post),
                               (blocks[1], slot_pass.slot_pre_plain,
                                slot_pass.slot_post_plain)):
            src = (c["xs"], c["vs"], acc0) if i == 0 else (blk.xs, blk.vs,
                                                           blk.acc)
            kick = leap and src[2] is not None
            pre(blk, *src, c["movb"], addr.gcounts, addr.n_occ,
                sp.params.dt, kick, leap, i == 0, centers)
            feat = blk.kernel_feat
            rp = tps._call_density(feat, addr, sg, sp.params, c["jb"])
            f = tps._call_force(feat, rp, addr, sg, sp.params, c["jb"])
            post(blk, rp, f, c["x0s"], c["movb"], addr, plan, c["step0"], i,
                 i == 2)
        torch.cuda.synchronize()
        assert slot_pass.LAUNCHES["slot_pre"] == before["slot_pre"] + 1
        assert slot_pass.LAUNCHES["slot_post"] == before["slot_post"] + 1
        a, b = blocks
        assert _bitwise(a.feat, b.feat), i
        if bf16:
            assert _bitwise(a.feat16, b.feat16), i
        assert _bitwise(a.acc, b.acc), i
        assert int(a.count) == int(b.count), i
        assert int(a.risky) == int(b.risky), i


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_slot_steps_on_card_bitwise_the_replaced_sequence(name):
    """`_slot_steps` through the kernels against the frozen sequence run by
    PyTorch's own kernels on the card: every rounding, the drift's
    torch.sum order and each sign of zero are PyTorch's."""
    _card()
    sp, grid, c, leap, half2 = _case(name, dev="cuda")
    _equal_runs(sp, grid, c, leap, half2, budget=0.0)
