"""Seeded random scenes for the port's robustness net.

The port's copy of the reference's fuzz generators (tests/test_fuzz.py):
`random_scene` (:17-49), the feature-matrix scene (`feature_scene`,
:146-180: static boundary particles, an emitter and a force field in one
random scene) and the live spawn bursts (`spawn_bursts`, :218-240).  Each
makes the same numpy draws in the same order as the reference, so a seed
gives the same scene, JSON for JSON, in both packages
(tests/test_torch_fuzz.py holds that).

`extend` adds what the reference's generator never draws, each picked by
the seed: `pressure_floor`, a force field over the whole run and a second
one whose live window ends inside it, and a `spawn_reserve`.  Only the
port's own seeds (`PORT_SEEDS`) use it; the CPU tests hold those seeds to
the reference too.

This module imports numpy and `sph_tpu_torch` only, so that
`chip_smoke.py` runs the same scenes on the card.
"""

from __future__ import annotations

import numpy as np

from sph_tpu_torch.params import (
    Block,
    Emitter,
    ForceField,
    Scene,
    SimParams,
    calibrate,
)

# the reference's seeds, by case of tests/test_fuzz.py
PATHS_SEEDS = (101, 202, 303, 404)          # the three paths agree (:51)
RESIDENT_SEEDS = (515, 616)                 # resident == classic (:79)
POLICY_SEEDS = (919, 1020)                  # auto policies (:105)
FEATURE_SEEDS = (717, 818)                  # full feature matrix (:138)
SPAWN_SEEDS = (919, 1020)                   # live spawn mid-run (:207)
REFERENCE_SEEDS = (PATHS_SEEDS + RESIDENT_SEEDS + POLICY_SEEDS
                   + FEATURE_SEEDS)
# the port's own, through `extend`: between them 2-D and 3-D, both
# integrators, clamp and penalty walls in 3-D, the pressure floor on and
# off, and a second force field that stops inside the run
PORT_SEEDS = (21, 12, 31, 58)
# the steps a trajectory of an extended scene runs; the second force
# field stops before it
EXTEND_STEPS = 40
# the capacity the live spawn case keeps for injection (:215)
SPAWN_RESERVE = 512


def random_scene(rng) -> Scene:
    """A random scene over dim, h, EOS, integrator, kernel norm and wall
    mode: the reference's `_random_scene`, draw for draw."""
    dim = int(rng.choice([2, 3]))
    h = float(rng.uniform(8.0, 24.0))
    extent = float(rng.uniform(8, 20)) * h
    lo = tuple(0.0 for _ in range(dim))
    hi = tuple(extent for _ in range(dim))
    b_lo = tuple(float(rng.uniform(h + 4, extent * 0.4)) for _ in range(dim))
    b_hi = tuple(
        float(min(b + rng.uniform(2 * h, extent * 0.5), extent - h - 4))
        for b in b_lo
    )
    p = SimParams(
        dim=dim,
        h=h,
        gravity=tuple([0.0] * (dim - 1) + [-float(rng.uniform(5, 400))]),
        dt=float(rng.uniform(1e-4, 6e-4)),
        viscosity=float(rng.uniform(50, 500)),
        eos=str(rng.choice(["ideal", "tait"])),
        integrator=str(rng.choice(["euler", "leapfrog"])),
        kernel_norm=str(rng.choice(["proper", "legacy3d"])),
        boundary_mode=str(rng.choice(["clamp", "penalty"])),
        wall_eps=h,
    )
    return calibrate(
        Scene(
            params=p,
            lo=lo,
            hi=hi,
            blocks=(Block(lo=b_lo, hi=b_hi),),
            seed=int(rng.integers(0, 1 << 16)),
        )
    )


def feature_scene(rng) -> Scene:
    """A random scene with a floor of static boundary particles
    (`kind == 1`), an emitter from step 3 and a force field from step 0:
    the reference's full feature matrix, draw for draw."""
    base = random_scene(rng)
    p = base.params
    dim = p.dim
    ext = base.hi[0]
    s = p.h * 0.55
    floor = Block(
        lo=base.lo,
        hi=tuple(2 * s if a == dim - 1 else base.hi[a] for a in range(dim)),
        kind=1,
    )
    nozzle = tuple(
        ext * 0.75 if a == 0 else base.hi[a] * 0.8 for a in range(dim)
    )
    jet = tuple(0.0 if a != dim - 1 else -30.0 for a in range(dim))
    return calibrate(
        base.replace(
            blocks=base.blocks + (floor,),
            emitters=(
                Emitter(pos=nozzle, velocity=jet, width=2, start_step=3),
            ),
            force_fields=(
                ForceField(
                    pos=tuple(e * 0.5 for e in base.hi),
                    strength=float(rng.uniform(-3e4, 3e4)),
                    radius=3 * p.h,
                    start_step=0,
                ),
            ),
        )
    )


def extend(scene: Scene, rng, n_steps: int = EXTEND_STEPS) -> Scene:
    """`scene` with what the reference's generator never draws, each
    picked by `rng`: the pressure floor on or off; a force field over the
    whole run and, on some seeds, a second one live on [start, stop)
    inside the first `n_steps` steps; a spawn reserve of 128, 256 or
    512."""
    p = scene.params
    floor = bool(rng.random() < 0.5)
    fields = []
    for k in range(1 + int(rng.random() < 0.5)):
        pos = tuple(float(rng.uniform(0.3, 0.7)) * e for e in scene.hi)
        strength = float(rng.uniform(-3e4, 3e4))
        radius = float(rng.uniform(2.0, 4.0)) * p.h
        if k == 0:
            start, stop = 0, 1 << 30
        else:
            start = int(rng.integers(0, n_steps // 2))
            stop = int(rng.integers(start + 1, n_steps))
        fields.append(ForceField(pos=pos, strength=strength, radius=radius,
                                 start_step=start, stop_step=stop))
    reserve = int(rng.choice([128, 256, 512]))
    return calibrate(scene.replace(
        params=p.replace(pressure_floor=floor),
        force_fields=scene.force_fields + tuple(fields),
        spawn_reserve=reserve,
    ))


def spawn_bursts(rng, scene: Scene, n_bursts: int = 3) -> list:
    """The live spawn case's bursts, each a dict of `state.spawn`'s
    keywords (pos, n, velocity, seed), drawn as the reference draws them
    between its dispatches."""
    lo, hi = np.asarray(scene.lo), np.asarray(scene.hi)
    out = []
    for burst in range(n_bursts):
        pos = lo + (0.25 + 0.5 * rng.random(scene.params.dim)) * (hi - lo)
        vel = rng.uniform(-20, 20, scene.params.dim)
        n = int(rng.integers(4, 64))
        out.append(dict(pos=pos, n=n, velocity=vel, seed=burst))
    return out


def scene_for(seed: int) -> Scene:
    """The scene a seed's cases start from: the feature matrix for
    FEATURE_SEEDS, `extend`ed for PORT_SEEDS, else the random scene."""
    rng = np.random.default_rng(seed)
    if seed in FEATURE_SEEDS:
        return feature_scene(rng)
    scene = random_scene(rng)
    return extend(scene, rng) if seed in PORT_SEEDS else scene


def spawn_case(seed: int) -> tuple:
    """(scene, bursts) of the live spawn case: the random scene with
    SPAWN_RESERVE slots kept for injection (a PORT_SEEDS scene `extend`ed,
    with its own reserve), then the bursts drawn from the same stream."""
    rng = np.random.default_rng(seed)
    scene = random_scene(rng)
    if seed in PORT_SEEDS:
        scene = extend(scene, rng)
    else:
        scene = scene.replace(spawn_reserve=SPAWN_RESERVE)
    return scene, spawn_bursts(rng, scene)
