"""The slab fast path of the port's decomposition on a four-rank gloo world
of spawned processes (`torch_decomp_worker.py`, suite "fast"), held to
`sph_tpu.decomp`'s fast path on `mesh1d(4)`, which the parent computes
while the ranks run (tests/test_domain_decomp.py:340-546, 756-1218 are the
reference's own cases, mirrored here on four slabs):

  * against the reference, the same options on the same inputs: no
    overflow, exact conservation of the active count, max|Δx| / scale <
    1e-4, and the counters (rebuilds, heals, repairs) equal — classic
    reuse (and the per-step slabs), migration (classic and auto-rebuild),
    emitters (classic and resident blocks), axis 1, the auto-rebuild
    residency with the membership, reactive and strict predicates, a jet
    whose blocks heal, the interior dart that repairs instead of
    rebuilding, and emitter activations that force a rebuild on every rank;
  * within the port, bitwise: the resident blocks == classic reuse (v to
    the reference's tolerance), rebuild_frac=0 == the resident blocks, a
    dispatch in which every block heals == the per-step slab advance (also
    when only rank 0's particles trigger the heals: every rank takes them),
    the band dart's vetoed repair == the repair-free run, and an emitter
    activation that bypasses repair;
  * the audited advance: its default, and constant-heal demotion with its
    re-probe (PERSTEP_REPROBE_EVERY = 2, as the reference's test sets it);
  * in this process: the argument rules, `precision="bf16"` refused on
    the resident blocks, and the slab helpers against the reference's.

The reference's advances are compiled once each and shared by the scenes
that differ only in their blocks (`torch_decomp_worker.LT`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_decomp_worker as worker

import sph_tpu_torch as port
from sph_tpu import decomp as jdc
from sph_tpu import params as jpm
from sph_tpu import pallas_step as jps
from sph_tpu import step as jstep
from sph_tpu.state import init as jinit
from sph_tpu_torch import decomp, neighbors, pallas_step, slot_pass
from sph_tpu_torch import step as step_mod

WORLD = 4
AUTO_BLOCKS = worker.AUTO // 4


class _Reference:
    """The reference's advances on mesh1d(WORLD), each compiled once."""

    def __init__(self):
        self.mesh = jdc.mesh1d(WORLD)
        self.advs = {}
        self.prime = None

    def start(self, name):
        scene = worker.fast_scene(jpm, name)
        state = jinit(scene)
        if scene.params.integrator == "leapfrog":
            if self.prime is None:
                # one compiled prime for the scenes of one parameter set
                self.prime = jax.jit(functools.partial(
                    jstep.prime, scene, method="pallas"))
            state = self.prime(state)
        spec = jdc.SpatialSpec.for_scene(
            scene, WORLD, state.capacity,
            axis=worker.FAST_AXIS.get(name, 0), balance=8.0)
        return scene, spec, state, jdc.spatial_shard_state(state, scene,
                                                           spec, self.mesh)

    def run(self, key, name, n, **kw):
        """n dispatches on the scene `name` of the advance `key`, made on
        first use from that scene → (merged state, summed counters)."""
        scene, spec, state, loc = self.start(name)
        if key not in self.advs:
            self.advs[key] = jdc.make_spatial_advance(
                scene, spec, self.mesh, method="pallas", sort_every=4, **kw)
        total = None
        for _ in range(n):
            res = self.advs[key](loc)
            loc = res[0]
            vals = np.array([int(v) for v in res[1:]], np.int64)
            total = vals if total is None else total + vals
        merged = jdc.spatial_gather_state(loc)
        return {"x": np.asarray(merged.x), "emit": np.asarray(merged.emit_step),
                "step": int(merged.step), "counts": total,
                "n_start": int(state.n_active())}


def _reference():
    ref = _Reference()
    classic = dict(steps_per_dispatch=worker.CLASSIC)
    auto = dict(steps_per_dispatch=worker.AUTO, slot_resident=True,
                auto_rebuild=True)
    out = {
        "fast_reuse": ref.run("classic", "wide", 1, **classic),
        "migrate": ref.run("classic", "migrate", 6, **classic),
    }
    for case, (name, n, opts) in worker.AUTO_RUNS.items():
        scenes = "lt" if name in worker.LT_SCENES else name
        key = ("auto", scenes) + tuple(sorted(opts.items()))
        out[case] = ref.run(key, name, n, **auto, **opts)
    out["emit"] = ref.run("emit", "emit", 4, **classic)
    out["emit_res"] = ref.run("emit_res", "emit", 4, slot_resident=True,
                              **classic)
    ref.prime = None
    out["axis1"] = ref.run("axis1", "axis1", 1, **classic)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    assert len(jax.devices()) >= WORLD
    out = tmp_path_factory.mktemp("decomp_fast")
    procs = worker.spawn("fast", WORLD, out)
    ref = _reference()      # here, while the ranks run
    got = worker.join(procs, out)
    got["log"] = (out / "rank0.log").read_text()
    return got, ref


def _active(r, prefix):
    step = int(r[f"{prefix}_step"])
    return r[f"{prefix}_x"][r[f"{prefix}_emit_step"] <= step]


def _sorted(x):
    return x[np.lexsort(x.T)]


def _dx_over_scale(x, x_ref):
    assert x.shape == x_ref.shape
    x, x_ref = _sorted(x), _sorted(x_ref)
    return np.max(np.abs(x - x_ref)) / (np.max(np.abs(x_ref)) + 1e-6)


def _held_to_reference(r, rr, prefix="m"):
    """No overflow on either side, the same step, exact conservation, and
    x within 1e-4 of the reference's position scale."""
    assert int(rr["counts"][0]) == 0
    step = int(r[f"{prefix}_step"])
    assert step == rr["step"]
    x = _active(r, prefix)
    x_ref = rr["x"][rr["emit"] <= step]
    assert x.shape == x_ref.shape
    assert _dx_over_scale(x, x_ref) < 1e-4


def _bitwise(r, a, b, fields=("x", "v", "rho", "p", "emit_step")):
    for k in fields:
        assert np.array_equal(r[f"{a}_{k}"], r[f"{b}_{k}"]), k


def test_classic_reuse_tracks_per_step_and_reference(results):
    got, ref = results
    r = got["fast_reuse"]
    assert r["counts"].tolist() == [[0], [0], [0]]
    _held_to_reference(r, ref["fast_reuse"], "fast")
    n = ref["fast_reuse"]["n_start"]
    assert len(_active(r, "fast")) == len(_active(r, "per")) == n
    assert _dx_over_scale(_active(r, "fast"), _active(r, "per")) < 1e-4


@pytest.mark.parametrize("case,a", [("fast_reuse", "fast"), ("migrate", "m"),
                                    ("emit", "m"), ("axis1", "m")])
def test_resident_blocks_bitwise_classic_reuse(results, case, a):
    """x, rho, p and the active set bitwise; v to the reference's own
    tolerance (tests/test_domain_decomp.py:502-506): classic reuse hands K2
    PyTorch's EOS p of the per-particle rho, the resident blocks K1's p of
    the slot-layout rho, and PyTorch's vectorized pow on the CPU rounds by
    an element's lane in the vector, so the forces, and the last kick of
    v, differ in the last bit on a few particles (ROADMAP.md Queue 3 item
    10)."""
    got, _ = results
    r = got[case]
    assert int(np.max(r["c_res"] if case != "fast_reuse"
                      else r["counts"][1])) == 0
    _bitwise(r, a, "res", ("x", "rho", "p", "emit_step"))
    assert np.allclose(r[f"{a}_v"], r["res_v"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["migrate", "emit", "axis1"])
def test_classic_reuse_matches_reference(results, case):
    got, ref = results
    r = got[case]
    assert int(np.max(r["c_cls"])) == 0
    _held_to_reference(r, ref[case])
    if case == "emit":
        # the resident blocks against the reference's resident blocks
        _held_to_reference(r, ref["emit_res"], "res")


def test_forced_rebuild_bitwise_resident_blocks(results):
    got, _ = results
    r = got["fast_forced"]
    assert r["c_res"].tolist() == [0]
    # worst, rebuilds (the dispatch top's build + one a block), healed
    assert r["c_auto"].tolist() == [0, 4, 0]
    _bitwise(r, "res", "auto")


@pytest.mark.parametrize("case", sorted(worker.AUTO_RUNS))
def test_auto_rebuild_matches_reference(results, case):
    got, ref = results
    r = got[case]
    assert r["counts"].tolist() == ref[case]["counts"].tolist()
    _held_to_reference(r, ref[case])
    # exact conservation: the start's particles and the scheduled emissions
    emit = r["m_emit_step"]
    scheduled = int(np.sum((emit != decomp.INACTIVE)
                           & (emit <= int(r["m_step"]))))
    assert int(r["after"].sum()) == scheduled
    if case == "emit_auto":
        assert scheduled > r["n_start"]
    else:
        assert scheduled == r["n_start"]


def test_auto_rebuild_stretches_and_tracks_resident_blocks(results):
    got, _ = results
    r = got["stretch"]
    _, rebuilds, healed = r["counts"].tolist()
    assert healed == 0 and rebuilds < AUTO_BLOCKS
    assert _dx_over_scale(_active(r, "m"), _active(r, "cls")) < 1e-4


def test_rebuild_predicates_order(results):
    got, _ = results
    rb = {c: got[c]["counts"][1] for c in ("stretch", "reactive", "strict")}
    assert all(got[c]["counts"][2] == 0 for c in rb)
    assert rb["reactive"] <= rb["strict"] and rb["stretch"] <= rb["strict"]


@pytest.mark.parametrize("case", ["migrate", "migrate_auto"])
def test_fast_path_migration_conserves(results, case):
    got, _ = results
    r = got[case]
    assert not np.array_equal(r["before"], r["after"])
    assert int(r["after"].sum()) == int(r["before"].sum()) == r["n_start"]


def test_fast_path_emitters_activate_on_schedule(results):
    got, _ = results
    r = got["emit"]
    for p in ("m", "res"):
        step = int(r[f"{p}_step"])
        emit = r[f"{p}_emit_step"]
        scheduled = (emit != decomp.INACTIVE) & (emit <= step)
        assert scheduled.sum() == len(_active(r, p)) > r["n_start"]
        assert np.isfinite(_active(r, p)).all()


def test_heal_every_block_bitwise_per_step(results):
    got, _ = results
    r = got["heal"]
    # worst, rebuilds (the dispatch top's build + one a heal), healed
    assert r["counts"].tolist() == [0, 4, 3]
    _bitwise(r, "m", "per")


def test_heal_of_one_rank_is_taken_by_every_rank(results):
    got, _ = results
    ranks = [got[f"one_rank_r{r}"] for r in range(WORLD)]
    # only rank 0 holds a particle fast enough to outrun the skin
    assert ranks[0]["max_speed"] > 1000.0
    assert all(r["max_speed"] < 100.0 for r in ranks[1:])
    for r in ranks:
        assert r["counts"].tolist() == [0, 4, 3]
        assert bool(r["bitwise_per_step"])
        assert int(r["after"]) == WORLD


def test_interior_dart_repairs_instead_of_rebuilding(results):
    got, _ = results
    plain, rep = got["dart"], got["dart_repair"]
    assert plain["counts"][2] == rep["counts"][2] == 0
    assert rep["counts"][3] >= 1
    assert rep["counts"][1] < plain["counts"][1]
    assert _dx_over_scale(_active(rep, "m"), _active(plain, "cls")) < 1e-4


def test_band_dart_vetoes_repair_bitwise(results):
    got, _ = results
    plain, rep = got["band_dart"], got["band_dart_repair"]
    assert rep["counts"][3] == 0
    assert rep["counts"][1] == plain["counts"][1]
    for k in ("x", "v"):
        assert np.array_equal(plain[f"m_{k}"], rep[f"m_{k}"])


def test_emitter_activation_bypasses_repair(results):
    got, _ = results
    r = got["emit_repair"]
    assert r["c_b"][0] == r["c_r"][0] == 0
    assert len(_active(r, "b")) == len(_active(r, "r")) == r["n_start"] + 2
    if r["c_r"][3] == 0:
        assert np.array_equal(r["b_x"], r["r_x"])
    assert r["c_r"][1] <= r["c_b"][1]


def test_constant_heal_demotes_and_reprobes(results):
    got, _ = results
    r = got["demote"]
    assert r["modes"].tolist() == ["resident", "resident", "perstep",
                                   "perstep", "perstep", "resident"]
    h = r["heals"].tolist()
    assert h[1] == 3 and h[3] > h[2]       # the re-probe heals again
    assert "demoting to the per-step spatial path" in got["log"]
    assert "resuming the resident spatial fast path" in got["log"]
    assert int(r["m_step"]) == 60
    assert len(_active(r, "m")) == r["n_start"]
    assert np.isfinite(_active(r, "m")).all()


def test_audited_advance_defaults_to_auto_rebuild(results):
    got, _ = results
    r = got["audited"]
    assert str(r["mode"]) == "resident"
    assert r["counts"].tolist()[:2] == [0, 0]      # no heal, no repair
    assert int(r["m_step"]) == 16
    assert len(_active(r, "m")) == r["n_start"]
    assert np.isfinite(_active(r, "m")).all()


# --- in this process ------------------------------------------------------


def _wide():
    scene = worker.fast_scene(port, "wide")
    return scene, decomp.SpatialSpec.for_scene(scene, WORLD, 1024)


ARGUMENT_RULES = {
    "not_a_multiple": (dict(steps_per_dispatch=10, sort_every=4),
                       "must be a multiple of sort_every=4"),
    "grid_reuse": (dict(method="grid", sort_every=4), "requires method"),
    "resident_per_step": (dict(slot_resident=True), "requires sort_every"),
    "auto_classic": (dict(sort_every=4, auto_rebuild=True),
                     "requires slot_resident"),
    "repair_strict": (dict(sort_every=4, slot_resident=True,
                           auto_rebuild=True, repair_k=8,
                           membership_audit=False), "membership_audit"),
    "repair_reactive": (dict(sort_every=4, slot_resident=True,
                             auto_rebuild=True, repair_k=8,
                             reactive_theta=0.7), "membership predicate"),
    "repair_forced": (dict(sort_every=4, slot_resident=True,
                           auto_rebuild=True, repair_k=8, rebuild_frac=0.0),
                      "membership predicate"),
}


@pytest.mark.parametrize("rule", sorted(ARGUMENT_RULES))
def test_fast_path_argument_rules(rule):
    scene, spec = _wide()
    kw, msg = ARGUMENT_RULES[rule]
    kw = {"method": "pallas", "steps_per_dispatch": 8, **kw}
    with pytest.raises(ValueError, match=msg):
        decomp.make_spatial_advance(scene, spec, **kw)


@pytest.mark.parametrize("auto", [False, True])
def test_bf16_refused_on_resident_blocks(auto):
    scene, spec = _wide()
    scene = scene.replace(params=scene.params.replace(precision="bf16"))
    with pytest.raises(ValueError, match="precision='bf16'"):
        decomp.make_spatial_advance(scene, spec, "pallas", 8, sort_every=4,
                                    slot_resident=True, auto_rebuild=auto)


def test_slot_rows_view_matches_reference():
    a = np.random.default_rng(0).normal(size=(5, 3, 256)).astype(np.float32)
    got = pallas_step.slot_rows_view(torch.from_numpy(a)).numpy()
    assert np.array_equal(got, np.asarray(jps.slot_rows_view(jnp.asarray(a))))


@pytest.mark.parametrize("k_dev", [0, 11])
def test_slab_membership_helpers_match_reference(k_dev):
    """Inside-bin, bin margin and the relaxed audit on a slab-local lattice
    shifted by `ci_offset`, against the reference's, on random slot
    positions around their build cells.  In 2-D the slot rows are the
    cells of axis 0 (the slab axis here) and the lanes those of axis 1."""
    from sph_tpu import neighbors as jnb

    scene, spec = _wide()
    skin = step_mod.default_skin(scene, 4)
    grid = neighbors.GridSpec.for_slab(scene, spec.slab_w, 0, skin=skin)
    jgrid = jnb.GridSpec.for_slab(worker.fast_scene(jpm, "wide"), spec.slab_w,
                                  0, skin=skin)
    assert (grid.shape, grid.cell, tuple(grid.lo)) == (
        jgrid.shape, jgrid.cell, tuple(jgrid.lo))
    sg = pallas_step.slot_grid(grid)
    rng = np.random.default_rng(k_dev)
    rows = rng.integers(0, grid.shape[0], size=(sg.c_rows, 1)).astype(np.int32)
    lane = (np.arange(sg.lanes, dtype=np.int32) // sg.cap - sg.xc)[None, :]
    cell = np.float32(grid.cell)
    base = [np.float32(grid.lo[0]) + (rows + k_dev + 0.5) * cell,
            np.float32(grid.lo[1]) + (lane + 0.5) * cell]
    xs = np.stack([np.broadcast_to(b, (sg.c_rows, sg.lanes))
                   + rng.uniform(-1.0, 1.0, (sg.c_rows, sg.lanes)) * cell
                   for b in base], axis=1).astype(np.float32)
    bad = rng.random((sg.c_rows, 1, sg.lanes)) < 0.5
    beyond = rng.random((sg.c_rows, 1, sg.lanes)) < 0.2
    refs = [rows, lane]
    t_refs = [torch.from_numpy(r) for r in refs]
    j_refs = [jnp.asarray(r) for r in refs]
    off = (k_dev, 0)
    j_off = jnp.asarray(off, jnp.int32)
    xt, xj = torch.from_numpy(xs), jnp.asarray(xs)
    ins = slot_pass.slot_inside_bin(xt, t_refs, grid, off).numpy()
    ins_j = np.asarray(jstep._slot_inside_bin(xj, j_refs, jgrid, j_off))
    assert np.array_equal(ins, ins_j) and 0 < ins.mean() < 1
    m = slot_pass.slot_bin_margin(xt, t_refs, grid, off).numpy()
    m_j = np.asarray(jstep._slot_bin_margin(xj, j_refs, jgrid, j_off))
    assert np.array_equal(m, m_j)
    relaxed = slot_pass.membership_bad(torch.from_numpy(bad), xt, t_refs,
                                       grid, off, torch.from_numpy(beyond))
    assert np.array_equal(relaxed.numpy(), bad & (~ins_j | beyond))
