"""The port's decomposition on a four-rank gloo world of spawned processes
(`torch_decomp_worker.py`, suite "world"), held to `sph_tpu.decomp` on
`mesh1d(4)`, which the parent computes while the ranks run:

  * the particle-DP step is bitwise the port's naive step over 10 steps
    (Euler, leapfrog + Tait, force fields), and within 1e-4 of the
    position scale of the reference's `make_dp_step`;
  * per-step slabs, `make_spatial_advance` for methods naive, grid and
    pallas, grid with leapfrog + Tait, a migrating block, emitters and
    axis 1, hold the reference's own contract for a decomposed run
    (tests/test_domain_decomp.py:118-158): no overflow, exact conservation
    of the active count, and max|Δx| / scale < 1e-4 against the
    reference's decomposed run (slot order differs, so sorted positions);
  * migration really moves particles between slabs;
  * a spec too small for the ghosts raises SpatialCapOverflow on every
    rank from the same dispatch, and the group stays usable.
"""

import functools

import jax
import numpy as np
import pytest

import torch_decomp_worker as worker

from sph_tpu import decomp as jdc
from sph_tpu import params as jpm
from sph_tpu.state import init as jinit
from sph_tpu.step import prime as jprime

WORLD = 4
DP_CASES = ("dp_euler", "dp_leapfrog", "dp_fields")


def _prime(scene, state, method):
    """The reference's leapfrog prime, compiled as its `run` compiles it."""
    return jax.jit(functools.partial(jprime, scene, method=method))(state)


def _reference_dp(case):
    scene = worker.dp_scene(jpm, case)
    state = jinit(scene)
    if scene.params.integrator == "leapfrog":
        state = _prime(scene, state, "naive")
    mesh = jdc.mesh1d(WORLD)
    sharded = jdc.shard_state(state, mesh)
    step = jdc.make_dp_step(scene, mesh)
    for _ in range(10):
        sharded = step(sharded)
    cap = state.capacity
    return {"x": np.asarray(sharded.x)[:cap], "v": np.asarray(sharded.v)[:cap]}


def _reference_spatial(case):
    make, method, n_steps, axis, balance = worker.SPATIAL[case]
    scene = make(jpm)
    state = jinit(scene)
    if scene.params.integrator == "leapfrog":
        state = _prime(scene, state, method)
    mesh = jdc.mesh1d(WORLD)
    spec = jdc.SpatialSpec.for_scene(scene, WORLD, state.capacity, axis=axis,
                                     balance=balance)
    loc = jdc.spatial_shard_state(state, scene, spec, mesh)
    loc, overflow = jdc.make_spatial_advance(scene, spec, mesh, method,
                                             n_steps)(loc)
    merged = jdc.spatial_gather_state(loc)
    return {"x": np.asarray(merged.x), "emit": np.asarray(merged.emit_step),
            "step": int(merged.step), "overflow": int(overflow),
            "n_start": int(state.n_active())}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    assert len(jax.devices()) >= WORLD
    out = tmp_path_factory.mktemp("decomp_world")
    procs = worker.spawn("world", WORLD, out)
    # the reference runs here while the ranks run
    ref = {c: _reference_dp(c) for c in DP_CASES}
    ref.update({c: _reference_spatial(c) for c in worker.SPATIAL})
    return worker.join(procs, out), ref


def _sorted_active(x, active):
    xa = x[active]
    return xa[np.lexsort(xa.T)]


@pytest.mark.parametrize("case", DP_CASES)
def test_dp_step_bitwise_the_naive_step(results, case):
    got, _ = results
    r = got[case]
    cap = r["naive_x"].shape[0]
    for k in ("x", "v", "rho", "p", "acc"):
        assert np.array_equal(r[f"dp_{k}"][:cap], r[f"naive_{k}"]), k
    assert int(r["dp_step"]) == int(r["naive_step"]) == 10


@pytest.mark.parametrize("case", DP_CASES)
def test_dp_step_matches_reference(results, case):
    got, ref = results
    x, xr = got[case]["dp_x"][: ref[case]["x"].shape[0]], ref[case]["x"]
    scale = np.max(np.abs(xr)) + 1e-6
    assert np.max(np.abs(x - xr)) / scale < 1e-4
    v, vr = got[case]["dp_v"][: xr.shape[0]], ref[case]["v"]
    assert np.max(np.abs(v - vr)) / (np.max(np.abs(vr)) + 1e-6) < 1e-4


@pytest.mark.parametrize("case", sorted(worker.SPATIAL))
def test_spatial_matches_reference_decomposition(results, case):
    got, ref = results
    r, rr = got[case], ref[case]
    assert int(r["worst"]) == 0 == rr["overflow"]
    step = int(r["m_step"])
    assert step == rr["step"]
    act = r["m_emit_step"] <= step
    act_r = rr["emit"] <= step
    # exact conservation: nothing lost or duplicated by migration
    assert act.sum() == act_r.sum()
    assert r["m_x"].shape == rr["x"].shape
    if case != "emitters":
        assert act.sum() == rr["n_start"]
    else:   # the emitter fired on its schedule on the owning slab
        assert act.sum() > rr["n_start"]
    xm = _sorted_active(r["m_x"], act)
    xr = _sorted_active(rr["x"], act_r)
    scale = np.max(np.abs(xr)) + 1e-6
    assert np.max(np.abs(xm - xr)) / scale < 1e-4


def test_spatial_migration_happens(results):
    got, _ = results
    r = got["migration"]
    assert not np.array_equal(r["per_slab_before"], r["per_slab_after"])
    assert r["per_slab_after"].sum() == r["per_slab_before"].sum()


def test_spatial_cap_overflow_raises_on_every_rank(results):
    got, _ = results
    for rank in range(WORLD):
        r = got[f"overflow_r{rank}"]
        assert "overflowed a static buffer" in str(r["raised"]), rank
        assert int(r["after"]) == WORLD
