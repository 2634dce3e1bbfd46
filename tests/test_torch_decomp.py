"""The port's decomposition geometry (`sph_tpu_torch.decomp`,
`GridSpec.for_slab`, `ci_offset`, the split API) against `sph_tpu`, in one
process (no process group):

  * `GridSpec.for_slab` and each rank's float32 slab faces and integer
    cell offset (`decomp._slab_geometry`) equal the reference's;
  * `cell_index` and every `SlotAddr` field under a non-zero `ci_offset`
    (xsub 1 and 2, 2D and 3D) are exactly equal;
  * `scatter_rp` is exactly equal, and the split K1/K2 phases
    (`pallas_density_split` / `pallas_forces_split`, the plain versions
    here; Pallas interpret mode there) agree per particle within
    rtol 1e-5, atol 1e-6 (for f, atol 1e-6 of the force scale) on a
    slab-local lattice with ghost rho/p put in;
  * `SpatialSpec.for_scene` / `for_state` give the same fields, and
    `spatial_slabs` (the per-rank arrays of `spatial_shard_state`) the
    reference's stacked shards bit for bit.

The collectives themselves run in spawned gloo worlds
(`test_torch_decomp_world.py`, `test_torch_decomp_run.py`).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud

from sph_tpu import decomp as jdc
from sph_tpu import neighbors as jnb
from sph_tpu import pallas_step as jps
from sph_tpu import params as jpm
from sph_tpu import state as jst
import sph_tpu_torch as port
from sph_tpu_torch import decomp as tdc
from sph_tpu_torch import neighbors as tnb
from sph_tpu_torch import pallas_step as tps

torch.set_num_threads(1)

ADDR_FIELDS = ("pos", "valid", "row_pos", "gcounts", "n_occ", "nbr_pos",
               "overflow", "row_code", "center")


def _both(make):
    """The same scene built by each package: make(params_module)."""
    return make(jpm), make(port)


def _wide(m, axis=0, seed=61, **kw):
    """The reference suite's wide shallow pool (tests/test_domain_decomp.py
    `_wide_scene`), or its transpose for axis 1."""
    lo, hi = (0.0, 0.0), (1600.0, 300.0)
    blo, bhi, vel = (100.0, 20.0), (500.0, 200.0), (60.0, 0.0)
    if axis == 1:
        hi, blo, bhi, vel = hi[::-1], blo[::-1], bhi[::-1], vel[::-1]
    return m.calibrate(m.Scene(
        params=m.SimParams(boundary_mode="clamp", dt=5e-4, **kw),
        lo=lo, hi=hi, blocks=(m.Block(lo=blo, hi=bhi, velocity=vel),),
        seed=seed))


def _cube(m):
    p = m.SimParams(dim=3, gravity=(0.0, -9.81, 0.0), kernel_norm="proper")
    return m.calibrate(m.Scene(
        params=p, lo=(0.0,) * 3, hi=(600.0, 200.0, 200.0),
        blocks=(m.Block(lo=(20.0,) * 3, hi=(400.0, 120.0, 150.0)),),
        seed=7))


def _emitters(m):
    return m.calibrate(m.Scene(
        params=m.SimParams(boundary_mode="clamp", dt=5e-4),
        lo=(0.0, 0.0), hi=(1600.0, 300.0),
        blocks=(m.Block(lo=(100.0, 20.0), hi=(400.0, 120.0),
                        velocity=(60.0, 0.0)),),
        emitters=(m.Emitter(pos=(800.0, 250.0), velocity=(200.0, -150.0),
                            width=2),),
        capacity=2048, seed=66))


SCENES = {
    "wide": lambda m: _wide(m),
    "tall": lambda m: _wide(m, axis=1),
    "cube": _cube,
    "emitters": _emitters,
}

# name: (scene, n_shards, axis, skin)
SLABS = {
    "wide4": ("wide", 4, 0, 0.0),
    "wide8": ("wide", 8, 0, 0.0),
    "wide4_skin": ("wide", 4, 0, 3.0),
    "tall4_axis1": ("tall", 4, 1, 0.0),
    "cube3_axis0": ("cube", 3, 0, 0.0),
    "cube2_axis2_skin": ("cube", 2, 2, 2.5),
}


def _grid_fields(g):
    return (tuple(g.lo), g.cell, tuple(g.shape), g.cap, g.xsub)


@pytest.mark.parametrize("name", sorted(SLABS))
def test_for_slab_equals_reference(name):
    scene, n, axis, skin = SLABS[name]
    js, ts = _both(SCENES[scene])
    w = (js.hi[axis] - js.lo[axis]) / n
    jg = jnb.GridSpec.for_slab(js, w, axis, skin=skin)
    tg = tnb.GridSpec.for_slab(ts, w, axis, skin=skin)
    assert _grid_fields(tg) == _grid_fields(jg)
    full = tnb.GridSpec.for_scene(ts, skin=skin)
    assert tg.shape[axis] <= full.shape[axis]


def _ref_geometry(js, spec, grid, me):
    """The reference's per-device faces and offset, written out as
    sph_tpu/decomp.py:477-494 computes them under shard_map."""
    ax, h = spec.axis, js.params.h
    me = jnp.asarray(me, jnp.int32)
    my_lo = spec.slab_lo + me.astype(jnp.float32) * spec.slab_w
    my_hi = my_lo + spec.slab_w
    s_full = jnb.GridSpec.for_scene(js).shape[ax]
    k_dev = jnp.floor((my_lo - h - grid.cell - grid.lo[ax]) / grid.cell
                      ).astype(jnp.int32)
    k_dev = jnp.clip(k_dev, 0, s_full - grid.shape[ax])
    off = jnp.zeros((len(grid.shape),), jnp.int32).at[ax].set(1) * k_dev
    return (np.float32(my_lo), np.float32(my_hi), np.float32(my_lo + h),
            np.float32(my_hi - h), tuple(int(o) for o in np.asarray(off)))


@pytest.mark.parametrize("name", ["wide8", "tall4_axis1", "cube3_axis0"])
def test_slab_geometry_equals_reference(name):
    scene, n, axis, _ = SLABS[name]
    js, ts = _both(SCENES[scene])
    spec = jdc.SpatialSpec.for_scene(js, n, 4096, axis=axis)
    jg = jnb.GridSpec.for_slab(js, spec.slab_w, axis)
    tg = tnb.GridSpec.for_slab(ts, spec.slab_w, axis)
    offsets = set()
    for me in range(n):
        lo, hi, ci = tdc._slab_geometry(ts, spec, tg, me)
        want = _ref_geometry(js, spec, jg, me)
        got = (lo, hi, np.float32(lo + np.float32(ts.params.h)),
               np.float32(hi - np.float32(ts.params.h)), ci)
        assert [np.asarray(a).tobytes() for a in got[:4]] == [
            np.asarray(a).tobytes() for a in want[:4]]
        assert got[4] == want[4]
        offsets.add(ci[axis])
    assert len(offsets) > 1   # the ranks' lattices really differ


def _slab_cloud(ts, spec, me, n, seed, outside=False):
    """Particles over rank `me`'s slab and ghost bands (some beyond the
    slab-local lattice when `outside`), the rest of the box on the other
    axes; an inactive tail."""
    d, ax, h = ts.params.dim, spec.axis, ts.params.h
    lo = np.array(ts.lo, np.float32)
    hi = np.array(ts.hi, np.float32)
    lo[ax] = spec.slab_lo + me * spec.slab_w - h
    hi[ax] = spec.slab_lo + (me + 1) * spec.slab_w + h
    if outside:
        lo[ax] -= 2 * h
        hi[ax] += 2 * h
    x, v = random_cloud(n, d, lo, hi, seed=seed)
    active = np.ones(n, bool)
    active[int(0.9 * n):] = False
    return x, v, active


# name: (scene, n_shards, axis, rank, xsub, n, outside, cap)
ADDR_CASES = {
    "wide_r1_xsub1": ("wide", 4, 0, 1, 1, 600, False, None),
    "wide_r2_xsub2": ("wide", 4, 0, 2, 2, 600, False, None),
    "tall_r3_xsub2": ("tall", 4, 1, 3, 2, 600, True, None),
    "cube_r1_xsub1": ("cube", 3, 0, 1, 1, 900, True, None),
    "cube_r1_xsub2_cap8": ("cube", 3, 0, 1, 2, 900, False, 8),
}


def _addr_inputs(name):
    scene, n_sh, axis, me, xsub, n, outside, cap = ADDR_CASES[name]
    js, ts = _both(SCENES[scene])
    spec = jdc.SpatialSpec.for_scene(js, n_sh, 4096, axis=axis)
    jg = jnb.GridSpec.for_slab(js, spec.slab_w, axis, cap=cap)
    tg = tnb.GridSpec.for_slab(ts, spec.slab_w, axis, cap=cap)
    jg = dataclasses.replace(jg, xsub=xsub)
    tg = dataclasses.replace(tg, xsub=xsub)
    ci = tdc._slab_geometry(ts, spec, tg, me)[2]
    x, v, active = _slab_cloud(ts, spec, me, n, seed=70 + me, outside=outside)
    return js, ts, jg, tg, ci, x, v, active


# one compiled program, not op-by-op dispatch (several seconds a case)
_ref_build_addr = jax.jit(jps.build_addr, static_argnums=(2, 3))
_ref_slot_overflow = jax.jit(jps.slot_overflow, static_argnums=(2, 3))


@pytest.mark.parametrize("name", sorted(ADDR_CASES))
def test_cell_index_and_slot_addr_under_ci_offset(name):
    js, ts, jg, tg, ci, x, v, active = _addr_inputs(name)
    assert any(ci)
    jci = jnp.asarray(ci, jnp.int32)
    xa, aa = jnp.asarray(x), jnp.asarray(active)
    xt, at = torch.from_numpy(x), torch.from_numpy(active)
    for a, b in zip(tnb.cell_index(xt, at, tg, ci),
                    jnb.cell_index(xa, aa, jg, jci)):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int32))
    jsg, tsg = jps.slot_grid(jg), tps.slot_grid(tg)
    ja = _ref_build_addr(xa, aa, jg, jsg, jci)
    ta = tps.build_addr(xt, at, tg, tsg, ci)
    for k in ADDR_FIELDS:
        a, b = getattr(ta, k).numpy(), np.asarray(getattr(ja, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert int(ta.n_occ[0]) > 1
    over_t = tps.slot_overflow(xt, at, tg, tsg, ci)
    over_j = _ref_slot_overflow(xa, aa, jg, jsg, jci)
    assert tuple(map(int, over_t)) == tuple(map(int, over_j))


def _split_inputs(name):
    """A slab-local cloud whose last 20% play ghosts: their rho/p are
    'imported' (values made up here, as another rank's would be)."""
    js, ts, jg, tg, ci, x, v, active = _addr_inputs(name)
    n = x.shape[0]
    rng = np.random.default_rng(5)
    rho = rng.uniform(0.9, 1.1, n).astype(np.float32) * ts.params.rest_density
    p = rng.uniform(-50.0, 200.0, n).astype(np.float32)
    return js, ts, jg, tg, ci, x, v, active, rho, p


@pytest.mark.parametrize("name", ["wide_r1_xsub1", "cube_r1_xsub1"])
def test_scatter_rp_exactly_equal(name):
    js, ts, jg, tg, ci, x, v, active, rho, p = _split_inputs(name)
    jsg, tsg = jps.slot_grid(jg), tps.slot_grid(tg)
    ja = _ref_build_addr(jnp.asarray(x), jnp.asarray(active), jg, jsg,
                         jnp.asarray(ci, jnp.int32))
    ta = tps.build_addr(torch.from_numpy(x), torch.from_numpy(active), tg,
                        tsg, ci)
    got = tps.scatter_rp(ta, torch.from_numpy(rho), torch.from_numpy(p), tsg)
    want = jps.scatter_rp(ja, jnp.asarray(rho), jnp.asarray(p), jsg)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), np.asarray(want))


@functools.partial(jax.jit, static_argnames=("params", "grid"))
def _ref_split(x, v, active, ci, ghost, rho_in, p_in, params, grid):
    """The reference's split phases in one compiled program: (feat, rho,
    f), f on the locals' own rho (p = 10 (rho - 1)) and the ghosts'
    imported rho/p."""
    ctx = jps.pallas_split_build(x, v, active, params, grid,
                                 ci_offset=ci.astype(jnp.int32))
    rho = jps.pallas_density_split(ctx, params)
    rho_f = jnp.where(ghost, rho_in, rho)
    p_f = jnp.where(ghost, p_in, 10.0 * (rho - 1.0))
    f = jps.pallas_forces_split(ctx, rho_f, p_f, params, x.shape[1])
    return ctx.feat, rho, f


@pytest.mark.parametrize("name", ["wide_r2_xsub2", "cube_r1_xsub1"])
def test_split_density_and_forces_match_reference(name):
    js, ts, jg, tg, ci, x, v, active, rho_in, p_in = _split_inputs(name)
    n = x.shape[0]
    # locals keep their own rho; the ghost tail's rho/p come from outside
    ghost = np.arange(n) >= int(0.8 * n)
    feat_j, rho_j, f_j = map(np.asarray, _ref_split(
        *map(jnp.asarray, (x, v, active, ci, ghost, rho_in, p_in)),
        params=js.params, grid=jg))
    tctx = tps.pallas_split_build(torch.from_numpy(x), torch.from_numpy(v),
                                  torch.from_numpy(active), ts.params, tg,
                                  ci_offset=ci)
    assert np.array_equal(tctx.feat.numpy(), feat_j)
    rho_t = tps.pallas_density_split(tctx, ts.params).numpy()
    assert np.allclose(rho_t, rho_j, rtol=1e-5, atol=1e-6)
    rho = np.where(ghost, rho_in, rho_j).astype(np.float32)
    p = np.where(ghost, p_in, 10.0 * (rho_j - 1.0)).astype(np.float32)
    d = ts.params.dim
    f_t = tps.pallas_forces_split(tctx, torch.from_numpy(rho),
                                  torch.from_numpy(p), ts.params, d).numpy()
    # atol in units of the force scale: f is a force density of order
    # 1e3 here, and its near-zero components are differences of such terms
    scale = np.abs(f_j).max()
    assert scale > 0
    assert np.allclose(f_t, f_j, rtol=1e-5, atol=1e-6 * scale)
    # the one-shot forms build the same context
    f_t2 = tps.pallas_forces(torch.from_numpy(x), torch.from_numpy(v),
                             torch.from_numpy(rho), torch.from_numpy(p),
                             torch.from_numpy(active), ts.params, tg,
                             ci_offset=ci).numpy()
    assert np.array_equal(f_t2, f_t)
    rho_t2 = tps.pallas_density(torch.from_numpy(x), torch.from_numpy(active),
                                ts.params, tg, ci_offset=ci).numpy()
    assert np.array_equal(rho_t2, rho_t)


def _state_pair(scene_name):
    js, ts = _both(SCENES[scene_name])
    jstate = jst.init(js)
    tstate = port.init(ts, device="cpu")
    return js, ts, jstate, tstate


# name: (scene, n_shards, axis, for_state kw or None for for_scene, balance)
SPECS = {
    "wide4_scene": ("wide", 4, 0, None, 4.0),
    "wide8_scene_balance8": ("wide", 8, 0, None, 8.0),
    "tall4_scene_axis1": ("tall", 4, 1, None, 8.0),
    "wide4_state": ("wide", 4, 0, {}, None),
    "emitters4_state_skin": ("emitters", 4, 0, {"skin": 3.0}, None),
    "cube3_state_headroom": ("cube", 3, 0, {"headroom": 2.0}, None),
}


def _specs(name):
    scene, n, axis, kw, balance = SPECS[name]
    js, ts, jstate, tstate = _state_pair(scene)
    if kw is None:
        return (jdc.SpatialSpec.for_scene(js, n, jstate.capacity, axis=axis,
                                          balance=balance),
                tdc.SpatialSpec.for_scene(ts, n, tstate.capacity, axis=axis,
                                          balance=balance))
    return (jdc.SpatialSpec.for_state(js, jstate, n, axis=axis, **kw),
            tdc.SpatialSpec.for_state(ts, tstate, n, axis=axis, **kw))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spatial_spec_fields_equal(name):
    want, got = _specs(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [type(v) for v in dataclasses.astuple(got)] == [
        type(v) for v in dataclasses.astuple(want)]


def test_spatial_spec_rejects_thin_slabs():
    js, ts = _both(SCENES["wide"])
    for mod, scene in ((jdc, js), (tdc, ts)):
        with pytest.raises(ValueError, match="slab width"):
            mod.SpatialSpec.for_scene(scene, 200, 4096)


@pytest.mark.parametrize("name", ["wide8_scene_balance8", "tall4_scene_axis1",
                                  "emitters4_state_skin",
                                  "cube3_state_headroom"])
def test_spatial_slabs_bitwise_reference_shards(name):
    scene = SPECS[name][0]
    js, ts, jstate, tstate = _state_pair(scene)
    want_spec, spec = _specs(name)
    mesh = jdc.mesh1d(spec.n_shards)
    ref = jdc.spatial_shard_state(jstate, js, want_spec, mesh)
    slabs = tdc.spatial_slabs(tstate, spec)
    assert len(slabs) == spec.n_shards
    for k in tdc._ARRAYS:
        want = np.asarray(getattr(ref, k))
        got = np.stack([s[k] for s in slabs])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), k
    if scene == "emitters":   # pending slots ride with their slab
        pending = [int(((s["emit_step"] > 0)
                        & (s["emit_step"] != int(jst.INACTIVE))).sum())
                   for s in slabs]
        assert sum(pending) > 0


@pytest.mark.parametrize("cap", [64, 128])
def test_compaction_and_payloads_exactly_equal(cap):
    """`_pack_idx` (padded, overflow counted) and the ghost / migration
    send buffers against the reference's `_pack` of `_pack_payload` /
    `_pack_mig`, bit for bit: emit_step values past 2^24 and INACTIVE
    cross as bitcast floats."""
    rng = np.random.default_rng(cap)
    n, d = 300, 3
    mask = rng.random(n) < 0.3          # ~90 selected: overflows cap 64
    x, v = random_cloud(n, d, 0.0, 100.0, seed=cap)
    acc = rng.normal(size=(n, d)).astype(np.float32)
    kind = rng.integers(0, 2, n).astype(np.int32)
    emit = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    emit[:5] = (2**24 + 1, 2**30 + 3, 2**31 - 1, -7, 0)
    j = [jnp.asarray(a) for a in (mask, x, v, acc, kind, emit)]
    t = [torch.from_numpy(a) for a in (mask, x, v, acc, kind, emit)]
    idx_j, val_j, ov_j = jdc._pack_idx(j[0], cap)
    idx_t, val_t, ov_t = tdc._pack_idx(t[0], cap)
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert np.array_equal(val_t.numpy(), np.asarray(val_j))
    assert int(ov_t) == int(ov_j) == max(int(mask.sum()) - cap, 0)
    ghost_j, gval, _ = jdc._pack(j[0], jdc._pack_payload(j[1], j[2], d), cap)
    want = np.concatenate([np.asarray(ghost_j), np.asarray(gval)[:, None]],
                          axis=1).astype(np.float32)
    got = tdc._ghost_buffer(t[1], t[2], idx_t, val_t, d).numpy()
    assert got.shape == (cap, tdc.F_GHOST + 1)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    mig_j, mval, _ = jdc._pack(j[0], jdc._pack_mig(*j[1:], d), cap)
    want = np.concatenate([np.asarray(mig_j), np.asarray(mval)[:, None]],
                          axis=1).astype(np.float32)
    got = tdc._mig_buffer(*t[1:], idx_t, val_t, d).numpy()
    assert got.shape == (cap, tdc.F_MIG + 1)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    sel = np.nonzero(mask)[0][:cap]
    assert np.array_equal(got[: len(sel), 10].view(np.int32), emit[sel])
