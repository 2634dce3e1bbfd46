"""The reference's seeded fuzz (tests/test_fuzz.py) through the port: the
same random scenes, made by the port's generators in
tests/torch_fuzz_scenes.py, held against `sph_tpu` on the CPU.

- The generators: on every reference seed the port's scene is the
  reference's, `scene_to_json` for `scene_to_json`, and so are the live
  spawn bursts.
- The three paths (:51): on the reference's seeds and the port's own
  (`extend`ed: pressure floor, force fields, a spawn reserve), the port's
  naive, grid and pallas rho and f agree with the reference's per particle
  (rho rtol 1e-5 atol 1e-6, tests/test_pallas_equiv.py:55; f within 1e-4
  of the force scale, the reference's own bound between its paths), and 20
  grid steps stay finite with x within 1e-4 of the reference's position
  scale.

The full feature matrix is in tests/test_torch_fuzz_features.py, the
policy cases (resident == classic, the auto policies) in
tests/test_torch_fuzz_policy.py and the live spawn case in
tests/test_torch_fuzz_spawn.py, so that `--dist loadfile` gives them to
other workers; the physical invariants are in
tests/test_torch_invariants.py.  The reference runs as its own tests run
it: grid, and Pallas in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu_torch as port
import torch_fuzz_scenes as fs
from sph_tpu import neighbors as ref_nb
from sph_tpu import pallas_step as ref_ps
from sph_tpu import physics as ref_phys
from sph_tpu.step import make_step as ref_make_step
from sph_tpu.step import prime as ref_prime
from sph_tpu_torch import neighbors as nb
from sph_tpu_torch import pallas_step as ps
from sph_tpu_torch import physics as phys
from test_fuzz import _random_scene as ref_random_scene

torch.set_num_threads(1)

CPU = dict(device="cpu")
RHO_RTOL, RHO_ATOL = 1e-5, 1e-6
F_REL, X_REL = 1e-4, 1e-4


def ref_scene_of(scene):
    """The reference's copy of a port scene (JSON is exact for floats)."""
    return sph_tpu.scene_from_json(port.scene_to_json(scene))


def started(scene, prime_method: str):
    """(port scene, its state, reference scene, its state) from init, both
    primed under leapfrog by `prime_method`; the seeded positions bitwise
    equal."""
    rs = ref_scene_of(scene)
    rst, ost = sph_tpu.init(rs), port.init(scene, **CPU)
    assert np.array_equal(ost.x.numpy(), np.asarray(rst.x))
    assert np.array_equal(ost.emit_step.numpy(), np.asarray(rst.emit_step))
    if scene.params.integrator == "leapfrog":
        rst = ref_prime(rs, rst, method=prime_method)
        ost = port.prime(scene, ost, method=prime_method, **CPU)
    return scene, ost, rs, rst


def naive(mod, x, v, params):
    """(rho, f) of the naive path of package `mod.physics` over all of
    `x`, `v` (every particle active)."""
    ones = (jnp.ones(x.shape[0], bool) if mod is ref_phys
            else torch.ones(x.shape[0], dtype=torch.bool))
    rho = mod.density_naive(x, ones, params)
    return rho, mod.forces_naive(x, v, rho, mod.eos_pressure(rho, params),
                                 ones, params)


def hold_paths(scene, ost, rs, rst, what):
    """Naive, grid and pallas rho and f of the port against the
    reference's, per particle, on the same state."""
    p, rp = scene.params, rs.params
    x, v, act = ost.x, ost.v, ost.active
    rx, rv, ract = rst.x, rst.v, rst.active
    a = act.numpy()
    assert np.array_equal(a, np.asarray(ract))
    ours = {"grid": nb.grid_rho_p_f(x, v, act, p,
                                    nb.GridSpec.for_scene(scene))[::2],
            "pallas": ps.pallas_rho_p_f(x, v, act, p,
                                        nb.GridSpec.for_scene(scene))[::2]}
    # the naive path on the active particles alone: an inactive j adds an
    # exact zero, and an emitter scene's capacity makes N² pairs of GiBs
    ours["naive"] = naive(phys, x[act], v[act], p)
    ai = jnp.asarray(np.flatnonzero(a))
    ours = {k: tuple(t.numpy() for t in r) for k, r in ours.items()}
    ref_grid = ref_nb.GridSpec.for_scene(rs)
    theirs = {"grid": ref_nb.grid_rho_p_f(rx, rv, ract, rp, ref_grid)[::2],
              "pallas": ref_ps.pallas_rho_p_f(rx, rv, ract, rp,
                                              ref_grid)[::2],
              "naive": naive(ref_phys, rx[ai], rv[ai], rp)}
    theirs = {k: tuple(np.asarray(t) for t in r) for k, r in theirs.items()}
    for path in ours:
        (rho, f), (rho_r, f_r) = ours[path], theirs[path]
        if path != "naive":
            rho, f, rho_r, f_r = rho[a], f[a], rho_r[a], f_r[a]
        assert np.all(np.isfinite(rho)) and np.all(np.isfinite(f))
        assert np.allclose(rho, rho_r, rtol=RHO_RTOL, atol=RHO_ATOL), (
            what, path, np.max(np.abs(rho - rho_r)))
        fs_ = np.max(np.abs(f_r)) + 1e-9
        assert np.max(np.abs(f - f_r)) / fs_ < F_REL, (what, path)


def grid_steps(scene, ost, rs, rst, n: int):
    """`n` grid steps of both packages from the same state: the port's
    state after them, its x against the reference's within X_REL of the
    reference's position scale."""
    step, ref_step = port.make_step(scene, "grid", **CPU), ref_make_step(
        rs, "grid")
    for _ in range(n):
        ost, rst = step(ost), ref_step(rst)
    act = np.asarray(rst.active)
    assert np.array_equal(ost.active.numpy(), act)
    xr, xo = np.asarray(rst.x)[act], ost.x.numpy()[act]
    assert np.all(np.isfinite(xo)) and np.all(np.isfinite(ost.v.numpy()))
    scale = np.max(np.abs(xr)) + 1e-9
    assert np.max(np.abs(xo - xr)) / scale < X_REL, np.max(np.abs(xo - xr))
    return ost


# ---------------------------------------------------------------------------
# The generators
# ---------------------------------------------------------------------------


def _ref_feature_json(seed: int) -> str:
    """tests/test_fuzz.py:144-180's scene, built with the reference's
    classes, as JSON."""
    from sph_tpu.params import Block, Emitter, ForceField, calibrate

    rng = np.random.default_rng(seed)
    base = ref_random_scene(rng)
    p = base.params
    dim = p.dim
    ext = base.hi[0]
    s = p.h * 0.55
    floor = Block(lo=base.lo, hi=tuple(
        2 * s if a == dim - 1 else base.hi[a] for a in range(dim)), kind=1)
    nozzle = tuple(ext * 0.75 if a == 0 else base.hi[a] * 0.8
                   for a in range(dim))
    jet = tuple(0.0 if a != dim - 1 else -30.0 for a in range(dim))
    scene = calibrate(base.replace(
        blocks=base.blocks + (floor,),
        emitters=(Emitter(pos=nozzle, velocity=jet, width=2, start_step=3),),
        force_fields=(ForceField(pos=tuple(e * 0.5 for e in base.hi),
                                 strength=float(rng.uniform(-3e4, 3e4)),
                                 radius=3 * p.h, start_step=0),)))
    return sph_tpu.scene_to_json(scene)


@pytest.mark.parametrize("seed", fs.REFERENCE_SEEDS)
def test_generators_draw_the_reference_scenes(seed):
    rng, ref_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    assert (port.scene_to_json(fs.random_scene(rng))
            == sph_tpu.scene_to_json(ref_random_scene(ref_rng)))
    assert rng.random() == ref_rng.random()      # the streams stay in step
    if seed in fs.FEATURE_SEEDS:
        assert (port.scene_to_json(fs.scene_for(seed))
                == _ref_feature_json(seed))
    if seed in fs.SPAWN_SEEDS:
        # the reference's live spawn case: its scene with a reserve, then
        # per burst a position, a velocity and a count (:214-225)
        scene, bursts = fs.spawn_case(seed)
        ref_rng = np.random.default_rng(seed)
        ref = ref_random_scene(ref_rng).replace(spawn_reserve=512)
        assert port.scene_to_json(scene) == sph_tpu.scene_to_json(ref)
        lo, hi = np.asarray(ref.lo), np.asarray(ref.hi)
        for burst, b in enumerate(bursts):
            pos = lo + (0.25 + 0.5 * ref_rng.random(ref.params.dim)) * (hi - lo)
            vel = ref_rng.uniform(-20, 20, ref.params.dim)
            n = int(ref_rng.integers(4, 64))
            assert np.array_equal(b["pos"], pos)
            assert np.array_equal(b["velocity"], vel)
            assert (b["n"], b["seed"]) == (n, burst)


def test_extend_draws_what_the_reference_never_does():
    """Between them the port's seeds cover both dims, both integrators,
    3-D penalty and clamp walls, the pressure floor on and off, and a
    second force field that stops inside the run."""
    scenes = [fs.scene_for(s) for s in fs.PORT_SEEDS]
    ps_ = [s.params for s in scenes]
    assert {p.dim for p in ps_} == {2, 3}
    assert {p.integrator for p in ps_} == {"euler", "leapfrog"}
    assert {p.boundary_mode for p in ps_ if p.dim == 3} == {"clamp",
                                                           "penalty"}
    assert {p.pressure_floor for p in ps_} == {False, True}
    assert all(s.spawn_reserve > 0 and s.force_fields for s in scenes)
    stops = [f.stop_step for s in scenes for f in s.force_fields[1:]]
    assert stops and all(0 < t < fs.EXTEND_STEPS for t in stops)
    # the JSON round trip keeps every field the reference reads
    for s in scenes:
        assert port.scene_to_json(ref_scene_of(s)) == port.scene_to_json(s)


# ---------------------------------------------------------------------------
# The three paths (tests/test_fuzz.py:51)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", fs.PATHS_SEEDS + fs.PORT_SEEDS)
def test_random_scene_paths_match_reference(seed):
    scene, ost, rs, rst = started(fs.scene_for(seed), "grid")
    hold_paths(scene, ost, rs, rst, seed)
    grid_steps(scene, ost, rs, rst, 20)
