"""The port's pencils (`sph_tpu_torch.decomp`: `PencilSpec`,
`pencil_shard_state`, `make_pencil_step` / `make_pencil_advance`,
`make_audited_pencil_advance`, `run(shards=(n1, n2))`;
`GridSpec.for_pencil`; `comm.RankGrid`) against `sph_tpu.decomp` on
`mesh2d(2, 2)`.

In one process: `PencilSpec.for_state` gives the reference's fields,
`GridSpec.for_pencil` its shapes, `pencil_parts` its stacked shards bit
for bit, each pencil's float32 faces and cell offsets its values, and on
a 3D lattice cut along the lane axis (a nonzero `ci_offset[-1]`) the cell
indices, every `SlotAddr` field, the slot overflow and the split feature
slots are exactly the reference's, and the split K1's rho within rtol
1e-5, atol 1e-6 (the plain K1's sum order is not Pallas interpret's).

In one four-rank gloo world of `torch_decomp_worker.py` (suite "pencil",
a 2x2 rank grid), while the parent runs the reference: the drifting block
across both interior faces and their corner (grid and pallas), a diagonal
block migrating across both axes, emitters, and the 3D leapfrog/Tait
smoke with axis2 = 2 hold the reference's own contract
(tests/test_domain_decomp.py:570-720): overflow 0, the active count
exactly, max |dx| / scale < 1e-4 on sorted positions.  A spec too small
raises SpatialCapOverflow on every rank from the same dispatch, and
`run(shards=(2, 2))` tracks the single-device run.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_decomp_worker as worker
from helpers import random_cloud

from sph_tpu import decomp as jdc
from sph_tpu import neighbors as jnb
from sph_tpu import pallas_step as jps
from sph_tpu import params as jpm
from sph_tpu.state import init as jinit
from sph_tpu.step import prime as jprime
import sph_tpu_torch as port
from sph_tpu_torch import decomp as tdc
from sph_tpu_torch import neighbors as tnb
from sph_tpu_torch import pallas_step as tps

torch.set_num_threads(1)

WORLD = 4
N1, N2 = worker.PENCIL_GRID


def _prime(scene, state, method):
    return jax.jit(functools.partial(jprime, scene, method=method))(state)


def _reference_pencil(case):
    make, method, n_steps, kw = worker.PENCIL[case]
    scene = make(jpm)
    state = jinit(scene)
    if scene.params.integrator == "leapfrog":
        state = _prime(scene, state, method)
    mesh = jdc.mesh2d(N1, N2)
    spec = jdc.PencilSpec.for_state(scene, state, N1, N2, **kw)
    loc = jdc.pencil_shard_state(state, scene, spec, mesh)
    loc, overflow = jdc.make_pencil_advance(scene, spec, mesh, method,
                                            n_steps)(loc)
    merged = jdc.spatial_gather_state(loc)
    return {"x": np.asarray(merged.x), "emit": np.asarray(merged.emit_step),
            "step": int(merged.step), "overflow": int(overflow),
            "n_start": int(state.n_active()),
            "spec": str(dataclasses.astuple(spec)),
            "axes": (spec.axis1, spec.axis2),
            "ci_offsets": _reference_offsets(scene, spec)}


def _reference_offsets(scene, spec):
    """Each pencil's lattice offset as sph_tpu/decomp.py:2527-2537 computes
    it under shard_map, in rank order."""
    grid = jnb.GridSpec.for_pencil(scene, {spec.axis1: spec.w1,
                                           spec.axis2: spec.w2})
    s_full = jnb.GridSpec.for_scene(scene).shape
    out = []
    for r in range(spec.n1 * spec.n2):
        off = [0] * scene.params.dim
        for ax, lo, w, i in ((spec.axis1, spec.lo1, spec.w1, r // spec.n2),
                             (spec.axis2, spec.lo2, spec.w2, r % spec.n2)):
            my_lo = lo + jnp.asarray(i, jnp.int32).astype(jnp.float32) * w
            k = jnp.floor((my_lo - scene.params.h - grid.cell - grid.lo[ax])
                          / grid.cell).astype(jnp.int32)
            off[ax] = int(jnp.clip(k, 0, s_full[ax] - grid.shape[ax]))
        out.append(off)
    return np.array(out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    assert len(jax.devices()) >= WORLD
    out = tmp_path_factory.mktemp("pencil_world")
    procs = worker.spawn("pencil", WORLD, out)
    # the reference runs here while the ranks run
    ref = {c: _reference_pencil(c) for c in worker.PENCIL}
    return worker.join(procs, out), ref


def _sorted_active(x, active):
    xa = x[active]
    return xa[np.lexsort(xa.T)]


def _hold_to_reference(x, emit, step, xr, emit_r, step_r):
    assert step == step_r
    act, act_r = emit <= step, emit_r <= step_r
    assert act.sum() == act_r.sum()
    xm, xs = _sorted_active(x, act), _sorted_active(xr, act_r)
    scale = np.max(np.abs(xs)) + 1e-6
    assert np.max(np.abs(xm - xs)) / scale < 1e-4
    return int(act.sum())


@pytest.mark.parametrize("case", sorted(worker.PENCIL))
def test_pencil_matches_reference_decomposition(results, case):
    got, ref = results
    r, rr = got[case], ref[case]
    assert int(r["worst"]) == 0 == rr["overflow"]
    n_act = _hold_to_reference(r["m_x"], r["m_emit_step"], int(r["m_step"]),
                               rr["x"], rr["emit"], rr["step"])
    assert r["m_x"].shape == rr["x"].shape
    if case == "pencil_emitters":    # the emitter fired on its schedule
        assert n_act > rr["n_start"]
    else:
        assert n_act == rr["n_start"]


@pytest.mark.parametrize("case", sorted(worker.PENCIL))
def test_pencil_spec_and_lattices_in_the_world(results, case):
    got, ref = results
    r, rr = got[case], ref[case]
    assert str(r["spec"][0]) == rr["spec"]
    assert np.array_equal(r["ci_offsets"], rr["ci_offsets"])
    a1, a2 = rr["axes"]
    # every rank off the first row or column sits on a shifted lattice
    for rank, off in enumerate(r["ci_offsets"]):
        i1, i2 = divmod(rank, N2)
        assert (off[a1] > 0) == (i1 > 0)
        assert (off[a2] > 0) == (i2 > 0)
    if case == "pencil_3d":
        assert a2 == 2


def test_pencil_migration_both_axes(results):
    got, _ = results
    r = got["pencil_migration"]
    before, after = r["before"], r["after"]
    assert before.sum() == after.sum()
    # the block starts in pencil (0, 0) below the corner and reaches both
    # axis neighbors and, diagonally, pencil (1, 1)
    assert before[0] == before.sum()
    assert (after[1:] > 0).all()


def test_pencil_cap_overflow_raises_on_every_rank(results):
    got, _ = results
    for rank in range(WORLD):
        r = got[f"pencil_overflow_r{rank}"]
        assert "overflowed a static buffer" in str(r["raised"]), rank
        assert int(r["after"]) == WORLD


def test_run_pencils_tracks_single_device(results):
    """The reference's contract for its own run(shards=) (tests/
    test_domain_decomp.py:1220-1274): frames after each dispatch, the
    global state, conserved and within 1e-4 of the single-device run."""
    got, _ = results
    r = got["pencil_run"]
    assert list(r["frames"]) == [5, 10, 13]
    assert r["m_x"].shape[0] % WORLD == 0
    _hold_to_reference(r["m_x"], r["m_emit_step"], int(r["m_step"]),
                       r["ref_x"], r["ref_emit_step"], int(r["ref_step"]))


# ---------------------------------------------------------------------------
# In one process: the spec, the lattice, the shards, the addressing
# ---------------------------------------------------------------------------

# name: (scene function, n1, n2, for_state options)
SPECS = {
    "square_2x2": (worker.square, 2, 2, {}),
    "square_2x4": (worker.square, 2, 4, {}),
    "square_axes_swapped": (worker.square, 2, 2, {"axis1": 1, "axis2": 0}),
    "emitters_headroom": (worker.PENCIL["pencil_emitters"][0], 2, 2,
                          {"headroom": 6.0}),
    "cube_2x2_skin": (worker.cube3d, 2, 2, {"skin": 2.5}),
    "cube_axis1_2": (worker.cube3d, 2, 2, {"axis1": 1}),
}


def _pair(make):
    js, ts = make(jpm), make(port)
    return js, ts, jinit(js), port.init(ts, device="cpu")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_pencil_spec_fields_equal(name):
    make, n1, n2, kw = SPECS[name]
    js, ts, jstate, tstate = _pair(make)
    want = jdc.PencilSpec.for_state(js, jstate, n1, n2, **kw)
    got = tdc.PencilSpec.for_state(ts, tstate, n1, n2, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_pencil_spec_rejects_one_axis_and_thin_pencils():
    _, ts, _, tstate = _pair(worker.square)
    with pytest.raises(ValueError, match="axes must differ"):
        tdc.PencilSpec.for_state(ts, tstate, 2, 2, axis1=1, axis2=1)
    with pytest.raises(ValueError, match="< 2h"):
        tdc.PencilSpec.for_state(ts, tstate, 2, 40)


# name: (scene function, widths, skin)
LATTICES = {
    "square_2x2": (worker.square, {0: 400.0, 1: 400.0}, 0.0),
    "square_thin": (worker.square, {0: 100.0, 1: 50.0}, 0.0),
    "cube_0_2_skin": (worker.cube3d, {0: 200.0, 2: 100.0}, 2.5),
    "cube_one_axis": (worker.cube3d, {2: 100.0}, 0.0),
}


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_for_pencil_equals_reference(name):
    make, widths, skin = LATTICES[name]
    js, ts = make(jpm), make(port)
    jg = jnb.GridSpec.for_pencil(js, widths, skin=skin)
    tg = tnb.GridSpec.for_pencil(ts, widths, skin=skin)
    assert ((tuple(tg.lo), tg.cell, tuple(tg.shape), tg.cap, tg.xsub)
            == (tuple(jg.lo), jg.cell, tuple(jg.shape), jg.cap, jg.xsub))
    full = tnb.GridSpec.for_scene(ts, skin=skin)
    for a, s in enumerate(tg.shape):
        assert s < full.shape[a] if a in widths else s == full.shape[a]
    # one cut axis is the slab lattice
    if len(widths) == 1:
        ((a, w),) = widths.items()
        assert tg == tnb.GridSpec.for_slab(ts, w, a, skin=skin)


@pytest.mark.parametrize("name", ["square_2x2", "cube_2x2_skin"])
def test_pencil_parts_bitwise_reference_shards(name):
    make, n1, n2, kw = SPECS[name]
    js, ts, jstate, tstate = _pair(make)
    spec = tdc.PencilSpec.for_state(ts, tstate, n1, n2, **kw)
    jspec = jdc.PencilSpec.for_state(js, jstate, n1, n2, **kw)
    ref = jdc.pencil_shard_state(jstate, js, jspec, jdc.mesh2d(n1, n2))
    parts = tdc.pencil_parts(tstate, spec)
    assert len(parts) == n1 * n2
    for k, arrays in ((k, [p[k] for p in parts]) for k in parts[0]):
        assert np.array_equal(np.stack(arrays), np.asarray(getattr(ref, k))), k


@pytest.mark.parametrize("name", ["square_2x4", "cube_2x2_skin"])
def test_pencil_faces_equal_reference(name):
    make, n1, n2, kw = SPECS[name]
    js, ts, jstate, tstate = _pair(make)
    kw = {k: v for k, v in kw.items() if k != "skin"}
    spec = tdc.PencilSpec.for_state(ts, tstate, n1, n2, **kw)
    grid = tnb.GridSpec.for_pencil(ts, {spec.axis1: spec.w1,
                                        spec.axis2: spec.w2})
    want = _reference_offsets(js, jdc.PencilSpec.for_state(js, jstate, n1,
                                                           n2, **kw))
    h = np.float32(ts.params.h)
    for r in range(n1 * n2):
        off = [0] * ts.params.dim
        for ax, lo, w, i in ((spec.axis1, spec.lo1, spec.w1, r // n2),
                             (spec.axis2, spec.lo2, spec.w2, r % n2)):
            my_lo, my_hi, k = tdc._faces(ts, grid, ax, lo, w, i)
            ref_lo = np.float32(lo + jnp.asarray(i, jnp.int32)
                                .astype(jnp.float32) * w)
            assert my_lo.tobytes() == ref_lo.tobytes()
            assert my_hi.tobytes() == np.float32(ref_lo + np.float32(w)
                                                 ).tobytes()
            assert (np.float32(my_lo + h).tobytes()
                    == np.float32(ref_lo + h).tobytes())
            off[ax] = k
        assert off == list(want[r])


# one compiled program each, not op-by-op dispatch
_ref_build_addr = jax.jit(jps.build_addr, static_argnums=(2, 3))
_ref_slot_overflow = jax.jit(jps.slot_overflow, static_argnums=(2, 3))


@functools.partial(jax.jit, static_argnames=("params", "grid"))
def _ref_split_rho(x, v, active, ci, params, grid):
    ctx = jps.pallas_split_build(x, v, active, params, grid,
                                 ci_offset=ci.astype(jnp.int32))
    return ctx.feat, jps.pallas_density_split(ctx, params)


@pytest.mark.parametrize("xsub", [1, 2])
def test_addressing_on_a_3d_pencil_cut_along_the_lane_axis(xsub):
    """Pencil (1, 1) of a 2x2 cube cut along (0, 2): its lattice is
    restricted on the last (lane) axis too, so ci_offset[-1] != 0 enters
    the x-sub-cell arithmetic; a cloud over the pencil and both ghost
    bands, some beyond the lattice, an inactive tail."""
    js, ts, jstate, tstate = _pair(worker.cube3d)
    spec = tdc.PencilSpec.for_state(ts, tstate, 2, 2)
    assert (spec.axis1, spec.axis2) == (0, 2)
    widths = {spec.axis1: spec.w1, spec.axis2: spec.w2}
    jg = dataclasses.replace(jnb.GridSpec.for_pencil(js, widths), xsub=xsub)
    tg = dataclasses.replace(tnb.GridSpec.for_pencil(ts, widths), xsub=xsub)
    ci = [0, 0, 0]
    lo = np.array(ts.lo, np.float32)
    hi = np.array(ts.hi, np.float32)
    h = ts.params.h
    for ax, plo, w in ((0, spec.lo1, spec.w1), (2, spec.lo2, spec.w2)):
        my_lo, my_hi, ci[ax] = tdc._faces(ts, tg, ax, plo, w, 1)
        lo[ax], hi[ax] = my_lo - 3 * h, my_hi + 3 * h
    ci = tuple(ci)
    assert ci[0] > 0 and ci[-1] > 0
    x, v = random_cloud(1200, 3, lo, hi, seed=91)
    active = np.ones(1200, bool)
    active[1080:] = False
    xa, aa, jci = jnp.asarray(x), jnp.asarray(active), jnp.asarray(ci,
                                                                  jnp.int32)
    xt, at = torch.from_numpy(x), torch.from_numpy(active)
    for a, b in zip(tnb.cell_index(xt, at, tg, ci),
                    jnb.cell_index(xa, aa, jg, jci)):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int32))
    jsg, tsg = jps.slot_grid(jg), tps.slot_grid(tg)
    ja = _ref_build_addr(xa, aa, jg, jsg, jci)
    ta = tps.build_addr(xt, at, tg, tsg, ci)
    for k in ("pos", "valid", "row_pos", "gcounts", "n_occ", "nbr_pos",
              "overflow", "row_code", "center"):
        a, b = getattr(ta, k).numpy(), np.asarray(getattr(ja, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert int(ta.n_occ[0]) > 1
    assert tuple(map(int, tps.slot_overflow(xt, at, tg, tsg, ci))) == tuple(
        map(int, _ref_slot_overflow(xa, aa, jg, jsg, jci)))
    feat_j, rho_j = map(np.asarray, _ref_split_rho(
        xa, jnp.asarray(v), aa, jci, params=js.params, grid=jg))
    ctx = tps.pallas_split_build(xt, torch.from_numpy(v), at, ts.params, tg,
                                 ci_offset=ci)
    assert np.array_equal(ctx.feat.numpy(), feat_j)
    # the plain K1 sums a particle's pairs in another order than Pallas
    # interpret mode: test_torch_decomp.py's tolerance
    rho_t = tps.pallas_density_split(ctx, ts.params).numpy()
    assert np.allclose(rho_t, rho_j, rtol=1e-5, atol=1e-6)
