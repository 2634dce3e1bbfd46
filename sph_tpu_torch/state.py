"""Particle state and scene initialization (port of `sph_tpu/state.py`).

A fixed-capacity structure of arrays: every slot has an `emit_step`, and a
slot is active iff `emit_step <= state.step`, so emitting particles mid-run
changes no shapes and needs no host sync.  Inactive slots are parked far
outside the domain and masked out of all pair sums.

Seeding runs on the host with `numpy.random.default_rng(scene.seed)`, exactly
as the reference does, so `init` is bitwise equal to `sph_tpu.init`, and
`spawn` (live injection into never-activating slots) to `sph_tpu.spawn`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from sph_tpu_torch.params import Scene
from sph_tpu_torch.platform import resolve_device

INACTIVE = np.int32(2**31 - 1)  # emit_step sentinel: never activates

_FIELDS = ("x", "v", "acc", "rho", "p", "kind", "emit_step", "step")


@dataclass
class State:
    """Structure-of-arrays particle state; all arrays capacity-N on one device.

    x, v, acc : [N, D] f32  position / velocity / acceleration (force/rho)
    rho, p    : [N] f32     density / pressure (as of the last completed step)
    kind      : [N] i32     0 = fluid, 1 = static boundary particle
    emit_step : [N] i32     step at which the slot activates (INACTIVE = never)
    step      : [] i32      completed-step counter (kept on the device)
    """

    x: torch.Tensor
    v: torch.Tensor
    acc: torch.Tensor
    rho: torch.Tensor
    p: torch.Tensor
    kind: torch.Tensor
    emit_step: torch.Tensor
    step: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def active(self) -> torch.Tensor:
        """[N] bool — slots live at the current step."""
        return self.emit_step <= self.step

    def n_active(self) -> torch.Tensor:
        return torch.sum(self.active.to(torch.int32))

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    def to_numpy(self) -> dict[str, np.ndarray]:
        """{field: host array} — the form `sph_tpu.State` fields take under
        `np.asarray`, so states move between the two packages."""
        return {f: getattr(self, f).detach().cpu().numpy() for f in _FIELDS}

    @staticmethod
    def from_numpy(arrays: dict, device=None) -> "State":
        """Inverse of `to_numpy`; accepts anything `np.asarray` takes per
        field (e.g. the fields of a `sph_tpu.State`)."""
        dev = resolve_device(device)
        dtypes = dict(kind=np.int32, emit_step=np.int32, step=np.int32)
        return State(**{
            f: torch.from_numpy(
                np.array(arrays[f], dtype=dtypes.get(f, np.float32))
            ).to(dev)
            for f in _FIELDS
        })


def _lattice(lo, hi, spacing, rng, jitter_frac):
    """Host-side lattice fill of an axis-aligned box, with jitter."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    axes = [np.arange(l + spacing * 0.5, h, spacing) for l, h in zip(lo, hi)]
    # a block thinner than the pitch still seeds one plane at its midpoint
    axes = [
        a if a.size else np.array([(l + h) * 0.5]) for a, l, h in zip(axes, lo, hi)
    ]
    grids = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1)
    pts += (rng.random(pts.shape) - 0.5) * (jitter_frac * spacing)
    return pts.astype(np.float32)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def park_position(scene: Scene) -> np.ndarray:
    """Where inactive slots sit: far outside the domain (never a neighbor)."""
    lo = np.asarray(scene.lo, np.float32)
    return lo - np.float32(1e6)


def spawn(
    state: State, scene: Scene, pos, n: int = 64,
    velocity=None, radius: float | None = None, seed: int = 0,
) -> tuple[State, int]:
    """Live particle injection: claim up to `n` never-activating slots
    (emit_step == INACTIVE: capacity padding or expired emitter events) and
    schedule them to activate at the NEXT step, lattice-packed (+ scene
    jitter) inside a disc/sphere of `radius` around `pos` with initial
    `velocity`.

    Data surgery on the fixed-capacity state: no shape changes, and
    activation is `emit_step <= step`, evaluated inside the step.  The
    lattice is laid out on the host with the reference's numpy, so the
    result is bitwise equal to `sph_tpu.spawn`'s; reading `emit_step` back
    waits for the device once.

    Returns (state, n_spawned); n_spawned < n when free capacity, the
    packing disc, or the in-bounds clip runs out.  Spawned slots are fluid
    (kind 0) at rest density.
    """
    p = scene.params
    d = state.dim
    spacing = scene.spacing or p.h * 0.55
    pos = np.asarray(pos, np.float64)
    if pos.shape != (d,):
        raise ValueError(f"spawn pos must have dim {d}, got {pos.shape}")
    if radius is None:
        # disc/sphere just big enough to lattice-pack n at `spacing`
        vol_unit = np.pi if d == 2 else 4.0 / 3.0 * np.pi
        radius = spacing * (n / vol_unit) ** (1.0 / d) + spacing

    emit_host = state.emit_step.detach().cpu().numpy()
    free = np.flatnonzero(emit_host == INACTIVE)
    if n <= 0 or len(free) == 0:
        return state, 0

    # centered lattice clipped to the disc and to the domain interior;
    # bounded by what n needs (+ margin for disc/bounds clipping) so a
    # huge radius cannot allocate a huge meshgrid
    half_n = int(np.ceil(n ** (1.0 / d) / 2.0)) + 2
    half = min(int(np.ceil(radius / spacing)), max(half_n, 2))
    ax = (np.arange(-half, half + 1, dtype=np.float64)) * spacing
    pts = np.stack(
        np.meshgrid(*([ax] * d), indexing="ij"), axis=-1
    ).reshape(-1, d)
    pts = pts[np.argsort(np.sum(pts * pts, axis=1), kind="stable")]
    pts = pts[np.sum(pts * pts, axis=1) <= radius * radius] + pos[None, :]
    rng = np.random.default_rng(seed)
    pts = pts + (rng.random(pts.shape) - 0.5) * (scene.jitter * spacing)
    lo = np.asarray(scene.lo, np.float64) + 0.5 * spacing
    hi = np.asarray(scene.hi, np.float64) - 0.5 * spacing
    inb = np.all((pts >= lo) & (pts <= hi), axis=1)
    pts = pts[inb]

    k = int(min(n, len(pts), len(free)))
    if k == 0:
        return state, 0
    vel = np.zeros((d,), np.float32)
    if velocity is not None:
        vel = np.asarray(velocity, np.float32)
        if vel.shape != (d,):
            raise ValueError(
                f"spawn velocity must have dim {d}, got {vel.shape}"
            )
    dev = state.device
    idx = torch.from_numpy(free[:k]).to(dev)

    def put(t: torch.Tensor, values) -> torch.Tensor:
        out = t.clone()
        out[idx] = values
        return out

    return State(
        x=put(state.x, torch.from_numpy(pts[:k].astype(np.float32)).to(dev)),
        v=put(state.v, torch.from_numpy(vel).to(dev)),
        acc=put(state.acc, 0.0),
        rho=put(state.rho, float(np.float32(p.rest_density))),
        p=put(state.p, 0.0),
        kind=put(state.kind, 0),
        emit_step=put(state.emit_step, state.step + 1),
        step=state.step,
    ), k


def _init_host(scene: Scene, capacity_multiple: int) -> dict[str, np.ndarray]:
    """The seeded state as host arrays (the reference's `init`, line for
    line, up to the device transfer)."""
    p = scene.params
    d = p.dim
    spacing = scene.spacing or p.h * 0.55
    rng = np.random.default_rng(scene.seed)

    xs, kinds = [], []
    for b in scene.blocks:
        pts = _lattice(b.lo, b.hi, spacing, rng, scene.jitter)
        xs.append(pts)
        kinds.append(np.full(len(pts), b.kind, np.int32))
    x = np.concatenate(xs, 0) if xs else np.zeros((0, d), np.float32)
    kind = np.concatenate(kinds, 0) if kinds else np.zeros((0,), np.int32)
    n_seed = len(x)
    v = np.zeros_like(x)
    off = 0
    for b, pts in zip(scene.blocks, xs):
        if b.velocity is not None:
            v[off : off + len(pts)] = np.asarray(b.velocity, np.float32)
        off += len(pts)

    emit_step = np.zeros(n_seed, np.int32)

    # Emitter slots: schedule activation steps and precompute spawn states.
    cap = scene.capacity or 0
    if scene.emitters and not cap:
        cap = _round_up(max(4 * n_seed, 16384), capacity_multiple)
    cap = max(cap, _round_up(
        max(n_seed + max(scene.spawn_reserve, 0), 1), capacity_multiple
    ))

    # live-injection headroom: emitter schedules fill only the spare
    # capacity BEYOND the reserve, so `spawn_reserve` slots stay
    # emit_step == INACTIVE
    n_spare = max(cap - n_seed - max(scene.spawn_reserve, 0), 0)
    ex, ev, estep = [], [], []
    if scene.emitters and n_spare > 0:
        per = n_spare // len(scene.emitters)
        for em in scene.emitters:
            vel = np.asarray(em.velocity, np.float64)
            speed = float(np.linalg.norm(vel))
            if speed <= 0:
                raise ValueError("emitter velocity must be nonzero")
            # one emission row every `spacing` of downstream travel
            interval = max(1, round(spacing / (speed * p.dt)))
            # nozzle basis: unit vectors perpendicular to the jet
            n_hat = vel / speed
            perp = np.eye(d) - np.outer(n_hat, n_hat)
            basis = np.linalg.svd(perp)[0][:, : d - 1]  # [d, d-1]
            row = em.width ** (d - 1)
            lat = np.stack(
                np.meshgrid(
                    *([np.arange(em.width) - (em.width - 1) / 2] * (d - 1)),
                    indexing="ij",
                ),
                axis=-1,
            ).reshape(row, d - 1)
            offsets = lat @ basis.T * spacing  # [row, d]
            n_events = per // row
            steps = em.start_step + np.arange(n_events) * interval
            steps = np.where(steps < em.stop_step, steps, np.int64(INACTIVE))
            steps = np.repeat(steps, row)
            pos = (
                np.asarray(em.pos, np.float64)[None, :]
                + np.tile(offsets, (n_events, 1))
                + (rng.random((n_events * row, d)) - 0.5)
                * (em.jitter * spacing)
            )
            ex.append(pos.astype(np.float32))
            ev.append(
                np.broadcast_to(
                    vel.astype(np.float32), (n_events * row, d)
                ).copy()
            )
            estep.append(np.minimum(steps, INACTIVE).astype(np.int32))
        ex = np.concatenate(ex, 0)
        ev = np.concatenate(ev, 0)
        estep = np.concatenate(estep, 0)
    else:
        ex = np.zeros((0, d), np.float32)
        ev = np.zeros((0, d), np.float32)
        estep = np.zeros((0,), np.int32)

    n_used = n_seed + len(ex)
    n_pad = cap - n_used
    park = park_position(scene)

    # not-yet-active emitter slots already sit at their spawn point; they
    # are masked out of all sums until emit_step <= step
    return dict(
        x=np.concatenate(
            [x, ex, np.broadcast_to(park, (n_pad, d)).astype(np.float32)], 0
        ),
        v=np.concatenate([v, ev, np.zeros((n_pad, d), np.float32)], 0),
        acc=np.zeros((cap, d), np.float32),
        rho=np.full((cap,), np.float32(p.rest_density)),
        p=np.zeros((cap,), np.float32),
        kind=np.concatenate([kind, np.zeros(len(ex) + n_pad, np.int32)], 0),
        emit_step=np.concatenate(
            [emit_step, estep, np.full(n_pad, INACTIVE, np.int32)], 0
        ),
        step=np.asarray(0, np.int32),
    )


def init(scene: Scene, capacity_multiple: int = 256, device=None) -> State:
    """Seed a scene into a `State` on `device` (None = the CUDA card).

    Lattice-fills each `Block` (fluid or static boundary), schedules emitter
    slots with precomputed positions/velocities/activation steps, pads the
    capacity to a multiple of `capacity_multiple`, and parks the spare
    slots."""
    dev = resolve_device(device)
    return State.from_numpy(_init_host(scene, capacity_multiple), dev)
