"""Simulation parameters, scenes, and the preset configs (port of
`sph_tpu/params.py`, kept field for field so a scene's JSON reads in both
packages).  Everything here is *static* configuration: `SimParams` and
`Scene` are hashable frozen dataclasses closed over by `make_step`.

Physics knobs follow SURVEY.md §2.1: the reference's exact conventions are
unverifiable (empty mount), so each ambiguous choice is a config enum
(`kernel_norm`, `eos`, `integrator`, `boundary_mode`) covering both
literature-standard and tutorial-family conventions.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Literal

EOS = Literal["ideal", "tait"]
Integrator = Literal["euler", "leapfrog"]
KernelNorm = Literal["proper", "legacy3d"]
BoundaryMode = Literal["penalty", "clamp"]


@dataclass(frozen=True)
class SimParams:
    """Physics constants + numerical-scheme knobs (SURVEY.md §2.1).

    Units follow the tutorial family: positions in "pixels", gravity scaled
    to taste; the math is unit-agnostic.  `h` is the kernel support radius
    (W(r)=0 for r>=h); the grid cell size equals `h`.
    """

    dim: int = 2
    h: float = 16.0                 # smoothing / support radius
    mass: float = 2.5               # per-particle mass; see calibrate()
    rest_density: float = 1000.0    # rho_0
    stiffness: float = 2e5          # k in p = k (rho - rho_0)   [eos="ideal"]
    sound_speed: float = 450.0      # c_0 in Tait EOS            [eos="tait"]
    tait_gamma: float = 7.0
    viscosity: float = 200.0        # mu
    gravity: tuple[float, ...] = (0.0, -9.81)   # length == dim
    dt: float = 7e-4

    eos: str = "ideal"              # "ideal" | "tait"
    pressure_floor: bool = False    # clamp p >= 0
    integrator: str = "euler"       # "euler" (semi-implicit) | "leapfrog" (KDK)
    kernel_norm: str = "legacy3d"   # "proper" | "legacy3d" (2D codes reusing 3D consts)

    precision: str = "fp32"         # "fp32" | "bf16" — bf16 stores the pallas
    # candidate features (x, v) in bfloat16 with positions relative to the
    # build-time cell center, fed to the bf16 branch of K1/K2; pair math,
    # accumulation and the state stay fp32.  Affects only the pallas slot
    # path (naive stays fp32; packed rows refuse it).  On the H100 the bf16
    # kernels are slower than fp32 ones (PERF.md §6), so fp32 stays the
    # default.

    boundary_mode: str = "clamp"    # "clamp" (reflect+damp) | "penalty" (spring-damper)
    boundary_damping: float = -0.5  # velocity multiplier on wall hit [clamp mode]
    wall_stiffness: float = 1e6     # k_wall   [penalty mode, force-density units]
    wall_damping: float = 3e4       # c_wall   [penalty mode]
    wall_eps: float = 16.0          # wall inset (tutorial uses EPS = h)

    def __post_init__(self):
        if len(self.gravity) != self.dim:
            raise ValueError(
                f"gravity has {len(self.gravity)} components, dim={self.dim}"
            )

    def replace(self, **kw) -> "SimParams":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "SimParams":
        d = json.loads(s)
        d["gravity"] = tuple(d["gravity"])
        return SimParams(**d)


@dataclass(frozen=True)
class Block:
    """A lattice-seeded box of fluid (dam-break column etc.).

    `lo`/`hi` are corners; particles go on a `spacing`-pitch lattice with
    optional jitter.  `velocity` is the initial velocity of every particle.
    """

    lo: tuple[float, ...]
    hi: tuple[float, ...]
    velocity: tuple[float, ...] | None = None
    kind: int = 0  # 0 = fluid, 1 = static boundary particle


@dataclass(frozen=True)
class Emitter:
    """A jet nozzle: emits a row (2D) / square (3D) of `width` particles
    perpendicular to `velocity`, every `spacing/|velocity|` time units, so
    consecutive emissions stream `spacing` apart (no overlap explosions).

    The scene pre-allocates capacity; the step flips `active` masks on
    schedule (emit_step <= step) — no reshapes, no host sync.
    """

    pos: tuple[float, ...]
    velocity: tuple[float, ...]
    width: int = 4           # particles across the nozzle (width² in 3D)
    start_step: int = 0
    stop_step: int = 1 << 30
    jitter: float = 0.05     # position jitter in units of spacing


@dataclass(frozen=True)
class ForceField:
    """A scheduled external force probe — the headless form of the
    reference's mouse-drag interaction (SURVEY.md L5/C13): a radial pull
    (strength > 0) or push (< 0) toward `pos`, smoothly faded over `radius`,
    active on [start_step, stop_step)."""

    pos: tuple[float, ...]
    strength: float          # force-density magnitude at the center
    radius: float = 64.0
    start_step: int = 0
    stop_step: int = 1 << 30


@dataclass(frozen=True)
class Scene:
    """Scene description: domain, initial fluid blocks, emitters, capacity."""

    params: SimParams = field(default_factory=SimParams)
    lo: tuple[float, ...] = (0.0, 0.0)
    hi: tuple[float, ...] = (800.0, 600.0)
    blocks: tuple[Block, ...] = ()
    emitters: tuple[Emitter, ...] = ()
    force_fields: tuple[ForceField, ...] = ()
    capacity: int = 0        # 0 => just fits the seeded blocks
    spacing: float = 0.0     # 0 => h (lattice pitch)
    jitter: float = 0.01     # lattice jitter fraction of spacing
    seed: int = 0
    grid_cap: int = 0        # per-cell tile capacity (0 => auto; must | 128
                             # for the pallas path; see bench/bench_sweep.py)
    spawn_reserve: int = 0   # capacity slots kept never-activating for live
                             # injection (state.spawn / --interact spawn);
                             # emitter schedules fill only the REST of the
                             # spare capacity

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    @property
    def dim(self) -> int:
        return self.params.dim


def scene_to_json(scene: Scene) -> str:
    """Full Scene → JSON (SURVEY.md §5.6: JSON-loadable configs)."""
    return json.dumps(dataclasses.asdict(scene), indent=2)


def scene_from_json(s: str) -> Scene:
    d = json.loads(s)
    params = SimParams(**{**d["params"], "gravity": tuple(d["params"]["gravity"])})
    blocks = tuple(
        Block(
            lo=tuple(b["lo"]),
            hi=tuple(b["hi"]),
            velocity=tuple(b["velocity"]) if b["velocity"] else None,
            kind=b["kind"],
        )
        for b in d["blocks"]
    )
    emitters = tuple(
        Emitter(
            pos=tuple(e["pos"]),
            velocity=tuple(e["velocity"]),
            width=e["width"],
            start_step=e["start_step"],
            stop_step=e["stop_step"],
            jitter=e["jitter"],
        )
        for e in d["emitters"]
    )
    force_fields = tuple(
        ForceField(
            pos=tuple(f["pos"]),
            strength=f["strength"],
            radius=f["radius"],
            start_step=f["start_step"],
            stop_step=f["stop_step"],
        )
        for f in d.get("force_fields", ())
    )
    return Scene(
        params=params,
        lo=tuple(d["lo"]),
        hi=tuple(d["hi"]),
        blocks=blocks,
        emitters=emitters,
        force_fields=force_fields,
        capacity=d["capacity"],
        spacing=d["spacing"],
        jitter=d["jitter"],
        seed=d["seed"],
        grid_cap=d.get("grid_cap", 0),
        spawn_reserve=d.get("spawn_reserve", 0),
    )


def calibrate(scene: Scene) -> Scene:
    """Set particle mass so the seeded lattice density equals rest density.

    The reference's exact constants are unverifiable (SURVEY.md §0); an
    arbitrary (mass, h, spacing) triple generally makes the EOS see a huge
    density error at t=0 and the fluid explodes.  The standard SPH remedy:
    m = ρ₀ / Σ_lattice W(r), summing the kernel over an infinite lattice of
    pitch `spacing` (computed here over the support stencil, host-side).

    Pure host-side NumPy — scene building never touches a device.
    """
    import itertools
    import math

    import numpy as np

    from sph_tpu_torch.kernels import kernel_constants

    p = scene.params
    s = scene.spacing or p.h * 0.55
    reach = int(math.ceil(p.h / s))
    c_p, _, _ = kernel_constants(p.dim, p.h, p.kernel_norm)
    h2 = float(np.float32(p.h) * np.float32(p.h))
    w_sum = 0.0
    for off in itertools.product(range(-reach, reach + 1), repeat=p.dim):
        r2 = sum((o * s) ** 2 for o in off)
        q = max(h2 - float(np.float32(r2)), 0.0)  # fp32-rounded like the device path
        w_sum += float(np.float32(c_p) * np.float32(q) ** 3)
    mass = p.rest_density / w_sum
    return scene.replace(params=p.replace(mass=mass))


# ---------------------------------------------------------------------------
# The five BASELINE.json configs (BASELINE.json:6-12) as named presets.
# ---------------------------------------------------------------------------


def _dam_break_2d(n_target: int, capacity: int | None = None) -> Scene:
    """2D dam-break: a column of fluid in the left part of an 800x600 box."""
    p = SimParams()
    spacing = p.h * 0.55
    # Solve for a block whose lattice holds ~n_target particles, 1:2 aspect.
    import math

    nx = max(2, int(math.sqrt(n_target / 2.0)))
    ny = max(2, (n_target + nx - 1) // nx)
    w, hgt = nx * spacing, ny * spacing
    lo = (p.wall_eps + spacing, p.wall_eps + spacing)
    return Scene(
        params=p,
        lo=(0.0, 0.0),
        hi=(max(800.0, w * 3), max(600.0, hgt * 1.5)),
        blocks=(Block(lo=lo, hi=(lo[0] + w, lo[1] + hgt)),),
        capacity=capacity or 0,
    )


def _dam_break_3d(n_target: int) -> Scene:
    p = SimParams(
        dim=3,
        gravity=(0.0, -9.81, 0.0),
        eos="tait",
        integrator="leapfrog",
        kernel_norm="proper",
        boundary_mode="penalty",
        dt=4e-4,
    )
    spacing = p.h * 0.55
    import math

    n_side = max(2, round(n_target ** (1.0 / 3.0)))
    nx = n_side
    ny = max(2, (n_target + nx * nx - 1) // (nx * nx))
    w = nx * spacing
    lo = (p.wall_eps + spacing,) * 3
    # domain 2x the column width (room to collapse without paying for a
    # mostly-empty cell grid; slot-array memory scales with domain cells)
    hi_box = (
        max(800.0, w * 2),
        max(600.0, ny * spacing * 1.5),
        max(800.0, w * 2),
    )
    return Scene(
        params=p,
        lo=(0.0, 0.0, 0.0),
        hi=hi_box,
        blocks=(Block(lo=lo, hi=(lo[0] + w, lo[1] + ny * spacing, lo[2] + w)),),
    )


def _splash_3d_1m() -> Scene:
    """Config 4: 3D splash at 1M particles with static boundary particles."""
    base = _dam_break_3d(1_000_000)
    p = base.params
    spacing = p.h * 0.55
    # Floor slab of static boundary particles (kind=1), two layers thick.
    floor = Block(
        lo=(base.lo[0], base.lo[1], base.lo[2]),
        hi=(base.hi[0], base.lo[1] + 2 * spacing, base.hi[2]),
        kind=1,
    )
    return base.replace(blocks=base.blocks + (floor,))


def _multi_emitter_3d() -> Scene:
    p = SimParams(
        dim=3,
        gravity=(0.0, -9.81, 0.0),
        eos="tait",
        integrator="leapfrog",
        kernel_norm="proper",
        boundary_mode="penalty",
        dt=4e-4,
    )
    c = 400.0
    return Scene(
        params=p,
        lo=(0.0, 0.0, 0.0),
        hi=(800.0, 600.0, 800.0),
        blocks=(),
        emitters=(
            Emitter(pos=(100.0, 500.0, 100.0), velocity=(60.0, 0.0, 60.0)),
            Emitter(pos=(700.0, 500.0, 700.0), velocity=(-60.0, 0.0, -60.0)),
            Emitter(pos=(c, 550.0, c), velocity=(0.0, -80.0, 0.0), width=6),
        ),
        capacity=65536,
    )


def _fountain_2d() -> Scene:
    """Demo scene (NOT a BASELINE config): a shallow pool with a central
    fountain jet plus two side sprays — made for `sph-tpu record` and
    the live `--interact` hook (ROADMAP round-4: render demos).  The
    headless analog of the reference's interactive window session."""
    p = SimParams(boundary_mode="clamp")
    spacing = p.h * 0.55
    eps = p.wall_eps + spacing
    return Scene(
        params=p,
        lo=(0.0, 0.0),
        hi=(800.0, 600.0),
        blocks=(Block(lo=(eps, eps), hi=(800.0 - eps, 110.0)),),
        emitters=(
            Emitter(pos=(400.0, 130.0), velocity=(0.0, 300.0), width=3),
            Emitter(pos=(150.0, 560.0), velocity=(120.0, -40.0), width=2,
                    start_step=400),
            Emitter(pos=(650.0, 560.0), velocity=(-120.0, -40.0), width=2,
                    start_step=800),
        ),
        capacity=16384,
        spawn_reserve=2048,  # live-injection headroom (--interact spawn)
        seed=5,
    )


def _vortex_2d(n_target: int = 90_000) -> Scene:
    """Demo scene (NOT a BASELINE config): a pool stirred by a rotating
    ring of scheduled force pushes — the headless analog of dragging the
    mouse in a circle in the reference's interactive window (SURVEY.md
    L5/C13), at a scale the reference cannot reach.  36 staggered
    ForceFields sweep a radial push around a circle for 3 revolutions
    (steps 0-3600), driving a persistent vortex; afterwards the pool
    settles freely.  `sph-tpu record vortex2d --mode speed` shows the
    swirl; tests validate angular-momentum injection at reduced scale."""
    import math

    p = SimParams(boundary_mode="clamp")
    spacing = p.h * 0.55
    eps = p.wall_eps + spacing
    # pool sized to ~n_target on the seeding lattice
    width = 800.0 - 2 * eps
    depth = n_target * spacing * spacing / width
    n_spokes, cycles, w = 12, 3, 100
    cx, cy, r = 400.0, eps + depth * 0.5, min(170.0, width * 0.2)
    fields = []
    for c in range(cycles):
        for k in range(n_spokes):
            ang = 2.0 * math.pi * k / n_spokes
            t0 = (c * n_spokes + k) * w
            fields.append(ForceField(
                pos=(cx + r * math.cos(ang), cy + r * math.sin(ang)),
                strength=6e4, radius=120.0,
                start_step=t0, stop_step=t0 + w,
            ))
    return Scene(
        params=p,
        lo=(0.0, 0.0),
        hi=(800.0, 600.0),
        blocks=(Block(lo=(eps, eps), hi=(800.0 - eps, eps + depth)),),
        force_fields=tuple(fields),
        seed=7,
    )


_PRESETS = {
    # BASELINE.json:7 — tutorial default scene (naive all-pairs path)
    "tutorial2d": lambda: _dam_break_2d(1024),
    # BASELINE.json:8 — 10k particles, grid neighbor search
    "dam2d_10k": lambda: _dam_break_2d(10_000),
    # BASELINE.json:9 — 3D, 100k, WCSPH + viscosity, leapfrog
    "dam3d_100k": lambda: _dam_break_3d(100_000),
    # BASELINE.json:10 — 3D splash, 1M, static boundary particles, Pallas step
    "splash3d_1m": _splash_3d_1m,
    # BASELINE.json:11 — multi-emitter 3D scene with live render loop
    "emitters3d": _multi_emitter_3d,
    # demo scene (not in BASELINE): pool + fountain jets, for record/interact
    "fountain2d": _fountain_2d,
    # demo scene (not in BASELINE): rotating-stir vortex pool (90k, 2D)
    "vortex2d": _vortex_2d,
}


def preset(name: str) -> Scene:
    """Return a named scene: the five BASELINE configs (SURVEY.md §6)
    plus demo scenes.  All presets ship mass-calibrated (`calibrate`)."""
    try:
        return calibrate(_PRESETS[name]())
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; have {sorted(_PRESETS)}") from None


def preset_names() -> list[str]:
    return sorted(_PRESETS)
