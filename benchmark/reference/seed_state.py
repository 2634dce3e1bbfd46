"""The seeded state of a scene, made on the host from the seed alone.

A frozen copy of the scene generator the program uses at its start
(`numpy.random.default_rng(seed)`, blocks filled on a jittered lattice,
emitter slots scheduled, capacity padded and parked), so the benchmark
makes its own inputs and hands the same arrays to the program and to the
reference.  The scene is the plain dict of a configuration file.
"""

from __future__ import annotations

import numpy as np

INACTIVE = np.int32(2**31 - 1)   # emit_step of a slot that never activates
CAPACITY_MULTIPLE = 256
FIELDS = ("x", "v", "acc", "rho", "p", "kind", "emit_step", "step")


def _lattice(lo, hi, spacing, rng, jitter_frac):
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    axes = [np.arange(a + spacing * 0.5, b, spacing) for a, b in zip(lo, hi)]
    axes = [ax if ax.size else np.array([(a + b) * 0.5])
            for ax, a, b in zip(axes, lo, hi)]
    grids = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1)
    pts += (rng.random(pts.shape) - 0.5) * (jitter_frac * spacing)
    return pts.astype(np.float32)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def seed_arrays(scene: dict, seed: int) -> dict[str, np.ndarray]:
    """The eight state fields of `scene` seeded with `seed`, as host arrays."""
    p = scene["params"]
    d = p["dim"]
    spacing = scene["spacing"] or p["h"] * 0.55
    rng = np.random.default_rng(seed)

    xs, kinds = [], []
    for b in scene["blocks"]:
        pts = _lattice(b["lo"], b["hi"], spacing, rng, scene["jitter"])
        xs.append(pts)
        kinds.append(np.full(len(pts), b["kind"], np.int32))
    x = np.concatenate(xs, 0) if xs else np.zeros((0, d), np.float32)
    kind = np.concatenate(kinds, 0) if kinds else np.zeros((0,), np.int32)
    n_seed = len(x)
    v = np.zeros_like(x)
    off = 0
    for b, pts in zip(scene["blocks"], xs):
        if b["velocity"] is not None:
            v[off: off + len(pts)] = np.asarray(b["velocity"], np.float32)
        off += len(pts)
    emit_step = np.zeros(n_seed, np.int32)

    reserve = max(scene.get("spawn_reserve", 0), 0)
    cap = scene["capacity"] or 0
    if scene["emitters"] and not cap:
        cap = _round_up(max(4 * n_seed, 16384), CAPACITY_MULTIPLE)
    cap = max(cap, _round_up(max(n_seed + reserve, 1), CAPACITY_MULTIPLE))

    n_spare = max(cap - n_seed - reserve, 0)
    ex, ev, estep = [], [], []
    if scene["emitters"] and n_spare > 0:
        per = n_spare // len(scene["emitters"])
        for em in scene["emitters"]:
            vel = np.asarray(em["velocity"], np.float64)
            speed = float(np.linalg.norm(vel))
            if speed <= 0:
                raise ValueError("emitter velocity must be nonzero")
            interval = max(1, round(spacing / (speed * p["dt"])))
            n_hat = vel / speed
            perp = np.eye(d) - np.outer(n_hat, n_hat)
            basis = np.linalg.svd(perp)[0][:, : d - 1]
            row = em["width"] ** (d - 1)
            lat = np.stack(
                np.meshgrid(*([np.arange(em["width"]) - (em["width"] - 1) / 2]
                              * (d - 1)), indexing="ij"),
                axis=-1,
            ).reshape(row, d - 1)
            offsets = lat @ basis.T * spacing
            n_events = per // row
            steps = em["start_step"] + np.arange(n_events) * interval
            steps = np.where(steps < em["stop_step"], steps, np.int64(INACTIVE))
            steps = np.repeat(steps, row)
            pos = (np.asarray(em["pos"], np.float64)[None, :]
                   + np.tile(offsets, (n_events, 1))
                   + (rng.random((n_events * row, d)) - 0.5)
                   * (em["jitter"] * spacing))
            ex.append(pos.astype(np.float32))
            ev.append(np.broadcast_to(vel.astype(np.float32),
                                      (n_events * row, d)).copy())
            estep.append(np.minimum(steps, INACTIVE).astype(np.int32))
        ex, ev, estep = (np.concatenate(a, 0) for a in (ex, ev, estep))
    else:
        ex = np.zeros((0, d), np.float32)
        ev = np.zeros((0, d), np.float32)
        estep = np.zeros((0,), np.int32)

    n_pad = cap - n_seed - len(ex)
    park = np.asarray(scene["lo"], np.float32) - np.float32(1e6)
    return dict(
        x=np.concatenate(
            [x, ex, np.broadcast_to(park, (n_pad, d)).astype(np.float32)], 0),
        v=np.concatenate([v, ev, np.zeros((n_pad, d), np.float32)], 0),
        acc=np.zeros((cap, d), np.float32),
        rho=np.full((cap,), np.float32(p["rest_density"])),
        p=np.zeros((cap,), np.float32),
        kind=np.concatenate([kind, np.zeros(len(ex) + n_pad, np.int32)], 0),
        emit_step=np.concatenate(
            [emit_step, estep, np.full(n_pad, INACTIVE, np.int32)], 0),
        step=np.asarray(0, np.int32),
    )
