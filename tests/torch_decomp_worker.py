"""One rank of a gloo world for the decomposition tests
(`test_torch_decomp_world.py`, `test_torch_decomp_run.py`,
`test_torch_decomp_fast.py`, `test_torch_pencil.py`,
`test_torch_slot_storage.py`).

    python tests/torch_decomp_worker.py SUITE RANK WORLD STORE OUT

joins a `WORLD`-rank process group through the file store `STORE`, runs
every case of `SUITE` on the CPU, and writes each result as `OUT/<case>.npz`
(rank 0; cases whose outcome differs per rank write one file a rank).  It
imports only numpy, torch and `sph_tpu_torch`; the test that spawns it
(`spawn`, `join`) holds the results to `sph_tpu`.  The scene builders take
the parameter module (`sph_tpu.params` or `sph_tpu_torch`), so the tests
build the same scenes for the reference.  A file store in the test's own
directory, not a TCP port, so that files running side by side never meet.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import sph_tpu_torch as port
from sph_tpu_torch import decomp

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# Scenes (each takes the parameter module m)
# ---------------------------------------------------------------------------


def small_scene(m, seed, **kw):
    """tests/helpers.py `small_scene(dim=2)`."""
    p = m.SimParams(**kw)
    lo = (p.wall_eps + 4, p.wall_eps + 4)
    return m.calibrate(m.Scene(
        params=p, lo=(0.0, 0.0), hi=(400.0, 400.0),
        blocks=(m.Block(lo=lo, hi=(lo[0] + 120, lo[1] + 200)),), seed=seed))


def dp_scene(m, case):
    if case == "dp_euler":
        return small_scene(m, 60)
    if case == "dp_leapfrog":
        return small_scene(m, 63, integrator="leapfrog", eos="tait")
    return small_scene(m, 64).replace(force_fields=(
        m.ForceField(pos=(60.0, 60.0), strength=5e4, radius=80.0),))


def pool(m, seed=61, block=((100.0, 20.0), (500.0, 200.0)),
         velocity=(60.0, 0.0), axis=0, emitters=(), capacity=0, **kw):
    """A wide shallow pool (tests/test_domain_decomp.py `_wide_scene`), or
    its transpose for axis 1."""
    lo, hi = (0.0, 0.0), (1600.0, 300.0)
    (blo, bhi), vel = block, velocity
    if axis == 1:
        hi, blo, bhi, vel = hi[::-1], blo[::-1], bhi[::-1], vel[::-1]
    return m.calibrate(m.Scene(
        params=m.SimParams(boundary_mode="clamp", dt=5e-4, **kw),
        lo=lo, hi=hi, blocks=(m.Block(lo=blo, hi=bhi, velocity=vel),),
        emitters=emitters, capacity=capacity, seed=seed))


# case: (scene builder, method, steps, axis, SpatialSpec.for_scene balance)
SPATIAL = {
    "naive": (lambda m: pool(m), "naive", 10, 0, 4.0),
    "grid": (lambda m: pool(m), "grid", 40, 0, 4.0),
    "grid_leapfrog_tait": (
        lambda m: pool(m, integrator="leapfrog", eos="tait"), "grid", 40, 0,
        4.0),
    "pallas": (lambda m: pool(m), "pallas", 40, 0, 4.0),
    "migration": (
        lambda m: pool(m, seed=62, block=((300.0, 20.0), (399.0, 150.0)),
                       velocity=(300.0, 0.0)), "grid", 100, 0, 8.0),
    # emissions at steps 35 and 70
    "emitters": (
        lambda m: pool(m, seed=66, block=((100.0, 20.0), (400.0, 120.0)),
                       emitters=(m.Emitter(pos=(800.0, 250.0),
                                           velocity=(400.0, -300.0),
                                           width=2),),
                       capacity=1024), "grid", 80, 0, 8.0),
    "axis1": (lambda m: pool(m, seed=67, block=((100.0, 20.0),
                                                (500.0, 200.0)), axis=1),
              "grid", 40, 1, 8.0),
}

RUN_SCENE = "tutorial2d"

# The slab fast path (suite "fast"): the wide pool under leapfrog + Tait
# (tests/test_domain_decomp.py `_wide_scene(integrator="leapfrog",
# eos="tait")`), at one capacity, so that the reference's compiled
# advances serve several of these scenes: they differ in their blocks only.
LT = dict(integrator="leapfrog", eos="tait", capacity=1024)
DART_FACE = 711.3     # 0.7 before the cell face at 712.0, inside slab 1's
#                       interior [435.6, 764.4) for the whole run
BAND_DART = 408.7     # 0.7 before the face at 409.4, in slab 1's low band


def dart_pool(m, dart_x, **kw):
    """The wide pool, a 410 px/s dart at (dart_x, 250) and a static buoy
    line (tests/test_domain_decomp.py `_dart_pool_scene`): the dart's
    projected move trips the membership predicate at cell faces while its
    drift stays under skin/2."""
    base = pool(m, **{**LT, **kw})
    dart = m.Block(lo=(dart_x - 1.0, 249.0), hi=(dart_x + 1.0, 251.0),
                   velocity=(410.0, 0.0))
    buoys = m.Block(lo=(660.0, 96.0), hi=(790.0, 104.0), kind=1)
    return m.calibrate(base.replace(blocks=base.blocks + (dart, buoys)))


def fast_scene(m, name):
    if name == "wide":
        return pool(m, **LT)
    if name == "migrate":
        # a 250 px/s block that crosses the face at 400 within 100 steps
        return pool(m, seed=63, block=((220.0, 20.0), (395.0, 150.0)),
                    velocity=(250.0, 0.0), **LT)
    if name == "jet":
        # 4000 px/s: on four slabs every block outruns the skin (the
        # reference's 2000 px/s jet does so on its eight)
        return pool(m, velocity=(4000.0, 0.0), **LT)
    if name == "one_rank":
        # a jet inside slab 0 (over 12 steps it stays short of the band at
        # 364.4) and a calm block in slabs 1 and 2
        base = pool(m, block=((420.0, 20.0), (1000.0, 100.0)),
                    velocity=(0.0, 0.0), **LT)
        jet = m.Block(lo=(100.0, 20.0), hi=(300.0, 100.0),
                      velocity=(4000.0, 0.0))
        return m.calibrate(base.replace(blocks=base.blocks + (jet,)))
    if name == "dart":
        return dart_pool(m, DART_FACE)
    if name == "band_dart":
        return dart_pool(m, BAND_DART)
    if name == "emit_repair":
        base = dart_pool(m, DART_FACE)
        return m.calibrate(base.replace(
            emitters=(m.Emitter(pos=(300.0, 250.0), velocity=(0.0, -60.0),
                                width=2, start_step=6, stop_step=7),),
            capacity=1024 + 64))
    if name == "emit":
        return pool(m, seed=67, block=((100.0, 20.0), (400.0, 120.0)),
                    emitters=(m.Emitter(pos=(800.0, 250.0),
                                        velocity=(200.0, -150.0), width=2),),
                    capacity=2048)
    if name == "axis1":
        return pool(m, seed=68, axis=1)
    raise KeyError(name)


# the scenes of one parameter set and capacity: one compiled reference
# advance of each option set serves them all
LT_SCENES = {"wide", "migrate", "jet", "dart", "band_dart"}
# the slab axis of each fast-path scene (else 0); the specs come from
# SpatialSpec.for_scene with balance 8, so cap_local is the capacity
FAST_AXIS = {"axis1": 1}
# steps a dispatch of the reference's shared advances: classic reuse and
# resident blocks 24, auto-rebuild 32
CLASSIC, AUTO = 24, 32


def straddle(m):
    """A block across the face at x = 800 of two slabs: its ghost band is
    full from the first step."""
    return pool(m, seed=68, block=((700.0, 20.0), (900.0, 160.0)),
                velocity=(0.0, 0.0))


# Pencils (suite "pencil", a 2x2 rank grid): the reference suite's scenes
# (tests/test_domain_decomp.py:553-720), their blocks moved to straddle
# the one interior face of each axis (x = 400, y = 400) and their corner.
PENCIL_GRID = (2, 2)


def square(m, blocks=None, emitters=(), capacity=0):
    """tests/test_domain_decomp.py `_square_scene`: a drifting block whose
    traffic crosses the interior faces of both axes and the corner."""
    p = m.SimParams(boundary_mode="clamp", dt=5e-4)
    blocks = blocks or (m.Block(lo=(250.0, 250.0), hi=(550.0, 500.0),
                                velocity=(60.0, 30.0)),)
    return m.calibrate(m.Scene(params=p, lo=(0.0, 0.0), hi=(800.0, 800.0),
                               blocks=blocks, emitters=emitters,
                               capacity=capacity, seed=77))


def cube3d(m):
    """test_pencil_3d_smoke's scene: WCSPH leapfrog in 3D."""
    p = m.SimParams(dim=3, gravity=(0.0, -9.81, 0.0), eos="tait",
                    integrator="leapfrog", kernel_norm="proper",
                    boundary_mode="penalty", dt=4e-4)
    return m.calibrate(m.Scene(
        params=p, lo=(0.0, 0.0, 0.0), hi=(400.0, 200.0, 400.0),
        blocks=(m.Block(lo=(60.0, 30.0, 60.0), hi=(340.0, 120.0, 340.0)),),
        seed=78))


# case: (scene function, method, steps, PencilSpec.for_state options); the
# grid method is the slowest here, so it runs the shortest case
PENCIL = {
    "pencil_grid": (square, "grid", 30, {}),
    "pencil_pallas": (square, "pallas", 60, {}),
    # a diagonal block below the corner: migration across both axes,
    # diagonal moves included
    "pencil_migration": (
        lambda m: square(m, blocks=(m.Block(lo=(300.0, 320.0),
                                            hi=(398.0, 398.0),
                                            velocity=(250.0, 180.0)),)),
        "pallas", 150, {"headroom": 6.0}),
    "pencil_emitters": (
        lambda m: square(m, emitters=(m.Emitter(pos=(650.0, 650.0),
                                                velocity=(-150.0, -120.0),
                                                width=2),),
                         capacity=2048),
        "pallas", 150, {"headroom": 6.0}),
    # axis2 defaults to the last axis (2): the lane axis is cut
    "pencil_3d": (cube3d, "pallas", 8, {}),
}
PENCIL_RUN_SCENE = "tutorial2d"


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------


def _np(state) -> dict:
    return state.to_numpy()


def case_dp(case: str) -> dict:
    """The DP step over 10 steps (gathered), and on rank 0 the port's
    single-process naive step over the same 10."""
    scene = dp_scene(port, case)
    state = port.init(scene, device=CPU)
    if scene.params.integrator == "leapfrog":
        state = port.prime(scene, state, "naive", device=CPU)
    loc = decomp.shard_state(state, CPU)
    dp = decomp.make_dp_step(scene)
    for _ in range(10):
        loc = dp(loc)
    gathered = _np(decomp.spatial_gather_state(loc))
    out = {f"dp_{k}": v for k, v in gathered.items()}
    if dist.get_rank() == 0:
        ref = state
        naive = port.make_step(scene, "naive", device=CPU)
        for _ in range(10):
            ref = naive(ref)
        out.update({f"naive_{k}": v for k, v in _np(ref).items()})
    return out


def case_spatial(case: str) -> dict:
    make, method, n_steps, axis, balance = SPATIAL[case]
    scene = make(port)
    state = port.init(scene, device=CPU)
    if scene.params.integrator == "leapfrog":
        state = port.prime(scene, state, method, device=CPU)
    spec = decomp.SpatialSpec.for_scene(scene, dist.get_world_size(),
                                        state.capacity, axis=axis,
                                        balance=balance)
    loc = decomp.spatial_shard_state(state, scene, spec, CPU)
    before = decomp.comm.all_gather(loc.active.sum().reshape(1))
    # the first step alone (make_spatial_step), then one dispatch
    loc, first = decomp.make_spatial_step(scene, spec, method)(loc)
    adv = decomp.make_spatial_advance(scene, spec, method, n_steps - 1)
    loc, worst = adv(loc)
    worst = torch.maximum(worst, first)
    after = decomp.comm.all_gather(loc.active.sum().reshape(1))
    gathered = _np(decomp.spatial_gather_state(loc))
    out = {f"m_{k}": v for k, v in gathered.items()}
    out.update(worst=np.int64(worst), per_slab_before=before.numpy(),
               per_slab_after=after.numpy())
    return out


def case_overflow(_case: str) -> dict:
    """A spec whose ghost buffers are too small: every rank raises
    SpatialCapOverflow from the same dispatch."""
    scene = SPATIAL["grid"][0](port)
    state = port.init(scene, device=CPU)
    spec = decomp.SpatialSpec.for_scene(scene, dist.get_world_size(),
                                        state.capacity)
    spec = dataclasses.replace(spec, cap_ghost=8)
    loc = decomp.spatial_shard_state(state, scene, spec, CPU)
    adv = decomp.make_audited_spatial_advance(scene, spec, "grid", 5)
    try:
        adv(loc)
        raised = ""
    except decomp.SpatialCapOverflow as e:
        raised = str(e)
    # the group is still in step: one more collective completes
    total = decomp.comm.all_reduce_sum(torch.ones((), dtype=torch.int32))
    return {"raised": np.array(raised), "after": total.numpy()}


def case_run(case: str) -> dict:
    scene = port.preset(RUN_SCENE)
    frames = []
    out = port.run(scene, 13, method="grid", steps_per_dispatch=5,
                   shards=dist.get_world_size(), device=CPU,
                   frame_callback=lambda s: frames.append(int(s.step)))
    res = {f"m_{k}": v for k, v in _np(out).items()}
    res["frames"] = np.array(frames)
    if dist.get_rank() == 0:
        ref = port.run(scene, 13, method="grid", steps_per_dispatch=5,
                       device=CPU)
        res.update({f"ref_{k}": v for k, v in _np(ref).items()})
    return res


def case_run_packed_rows(case: str) -> dict:
    """packed_rows with shards: ignored with a notice, bitwise the run
    without it (the notice is checked in this rank's log)."""
    scene = port.preset(RUN_SCENE)
    kw = dict(method="grid", steps_per_dispatch=3,
              shards=dist.get_world_size(), device=CPU)
    a = port.run(scene, 6, packed_rows=True, **kw)
    b = port.run(scene, 6, **kw)
    return {"a_x": a.x.numpy(), "b_x": b.x.numpy(), "step": int(a.step)}


def case_run_elastic(case: str) -> dict:
    """The first spec's ghost buffers hold 8 particles: the first dispatch
    overflows on every rank, run() re-specs from the gathered state and
    goes on; the result equals a run that never overflowed."""
    scene = straddle(port)
    kw = dict(method="grid", steps_per_dispatch=4,
              shards=dist.get_world_size(), device=CPU)
    real = decomp.SpatialSpec.for_state
    calls = []

    def tight_once(*args, **kwargs):
        spec = real(*args, **kwargs)
        calls.append(spec)
        if len(calls) == 1:
            return dataclasses.replace(spec, cap_ghost=8)
        return spec

    decomp.SpatialSpec.for_state = staticmethod(tight_once)
    try:
        a = port.run(scene, 8, **kw)
    finally:
        decomp.SpatialSpec.for_state = staticmethod(real)
    b = port.run(scene, 8, **kw)
    return {"a_x": a.x.numpy(), "a_emit": a.emit_step.numpy(),
            "b_x": b.x.numpy(), "b_emit": b.emit_step.numpy(),
            "specs": np.int64(len(calls))}


def case_run_pallas(case: str) -> dict:
    scene = port.preset(RUN_SCENE)
    out = port.run(scene, 6, method="pallas", steps_per_dispatch=3,
                   shards=dist.get_world_size(), device=CPU)
    res = {f"m_{k}": v for k, v in _np(out).items()}
    if dist.get_rank() == 0:
        ref = port.run(scene, 6, method="pallas", steps_per_dispatch=3,
                       device=CPU)
        res.update({f"ref_{k}": v for k, v in _np(ref).items()})
    return res


# --- the slab fast path ----------------------------------------------------


def _fast_start(name):
    """(scene, spec, primed state, local state) of a fast-path scene."""
    scene = fast_scene(port, name)
    state = port.init(scene, device=CPU)
    if scene.params.integrator == "leapfrog":
        state = port.prime(scene, state, "pallas", device=CPU)
    spec = decomp.SpatialSpec.for_scene(
        scene, dist.get_world_size(), state.capacity,
        axis=FAST_AXIS.get(name, 0), balance=8.0)
    return scene, spec, state, decomp.spatial_shard_state(state, scene,
                                                          spec, CPU)


def _dispatches(adv, loc, n):
    """n dispatches of `adv`; (loc, [worst, counters...] summed)."""
    total = None
    for _ in range(n):
        res = adv(loc)
        loc = res[0]
        vals = np.array([int(t) for t in res[1:]], np.int64)
        total = vals if total is None else total + vals
    return loc, total


def _gathered(prefix, loc) -> dict:
    return {f"{prefix}_{k}": v
            for k, v in _np(decomp.spatial_gather_state(loc)).items()}


def _per_slab(loc):
    return decomp.comm.all_gather(loc.active.sum().reshape(1)).numpy()


def case_fast_reuse(case: str) -> dict:
    """Classic reuse (24 steps) against the per-step slabs and, bitwise,
    the slot-resident blocks."""
    scene, spec, _, loc = _fast_start("wide")
    kw = dict(steps_per_dispatch=CLASSIC, sort_every=4)
    fast, c_f = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", **kw), loc, 1)
    res, c_r = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", slot_resident=True, **kw), loc, 1)
    ref, c_p = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", CLASSIC), loc, 1)
    return {**_gathered("fast", fast), **_gathered("res", res),
            **_gathered("per", ref), "counts": np.stack([c_f, c_r, c_p])}


def case_fast_forced(case: str) -> dict:
    """rebuild_frac=0 (a rebuild at every block) against the resident
    blocks, 12 steps."""
    scene, spec, _, loc = _fast_start("wide")
    kw = dict(steps_per_dispatch=12, sort_every=4, slot_resident=True)
    a, c_a = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", **kw), loc, 1)
    b, c_b = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", auto_rebuild=True, rebuild_frac=0.0, **kw),
        loc, 1)
    return {**_gathered("res", a), **_gathered("auto", b),
            "c_res": c_a, "c_auto": c_b}


# case: (scene, dispatches, the auto-rebuild options) of each auto run
AUTO_RUNS = {
    "stretch": ("wide", 1, {}),
    "reactive": ("wide", 1, dict(reactive_theta=0.7)),
    "strict": ("wide", 1, dict(membership_audit=False)),
    "migrate_auto": ("migrate", 5, {}),
    "jet": ("jet", 1, {}),
    "dart": ("dart", 2, {}),
    "dart_repair": ("dart", 2, dict(repair_k=64)),
    "band_dart": ("band_dart", 1, {}),
    "band_dart_repair": ("band_dart", 1, dict(repair_k=64)),
    # emitter activations force a rebuild on every rank
    # (tests/test_domain_decomp.py `test_spatial_auto_emitters`)
    "emit_auto": ("emit", 3, {}),
}


def case_fast_auto(case: str) -> dict:
    name, n, opts = AUTO_RUNS[case]
    scene, spec, state, loc = _fast_start(name)
    before = _per_slab(loc)
    out, counts = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", AUTO, sort_every=4, slot_resident=True,
        auto_rebuild=True, **opts), loc, n)
    res = {**_gathered("m", out), "counts": counts, "before": before,
           "after": _per_slab(out), "n_start": int(state.n_active())}
    if case in ("stretch", "dart"):
        # the classic resident blocks over the same steps
        cls, _ = _dispatches(decomp.make_spatial_advance(
            scene, spec, "pallas", AUTO, sort_every=4, slot_resident=True),
            loc, n)
        res.update(_gathered("cls", cls))
    return res


def case_fast_heal(case: str) -> dict:
    """A jet dispatch in which every block heals (12 steps), against the
    per-step slabs; `one_rank`: the jet inside slab 0 alone, so that every
    rank heals on the audit of rank 0's particles, and the group is usable
    after (one file a rank)."""
    scene, spec, _, loc = _fast_start("jet" if case == "heal"
                                          else "one_rank")
    out, counts = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", 12, sort_every=4, slot_resident=True,
        auto_rebuild=True), loc, 1)
    per, _ = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", 12), loc, 1)
    if case == "heal":
        return {**_gathered("m", out), **_gathered("per", per),
                "counts": counts}
    speed = torch.sqrt(torch.sum(loc.v * loc.v, dim=1))[loc.active]
    same = all(torch.equal(getattr(out, k), getattr(per, k))
               for k in ("x", "v", "rho", "p", "emit_step"))
    after = decomp.comm.all_reduce_sum(torch.ones((), dtype=torch.int32))
    return {"counts": counts, "bitwise_per_step": np.array(same),
            "max_speed": float(speed.max()) if speed.numel() else 0.0,
            "after": after.numpy()}


def case_fast_classic(case: str) -> dict:
    """Classic reuse, and the resident blocks over the same dispatches:
    migration (6 dispatches), emitters (4) and axis 1 (1)."""
    name, n = {"migrate": ("migrate", 6), "emit": ("emit", 4),
               "axis1": ("axis1", 1)}[case]
    scene, spec, state, loc = _fast_start(name)
    before = _per_slab(loc)
    kw = dict(steps_per_dispatch=CLASSIC, sort_every=4)
    a, c_a = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", **kw), loc, n)
    b, c_b = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", slot_resident=True, **kw), loc, n)
    return {**_gathered("m", a), **_gathered("res", b), "c_cls": c_a,
            "c_res": c_b, "before": before, "after": _per_slab(a),
            "n_start": int(state.n_active())}


def case_fast_emit_repair(case: str) -> dict:
    """An emitter activation during the dispatch bypasses repair."""
    scene, spec, state, loc = _fast_start("emit_repair")
    kw = dict(sort_every=4, slot_resident=True, auto_rebuild=True)
    b, c_b = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", 16, **kw), loc, 1)
    r, c_r = _dispatches(decomp.make_spatial_advance(
        scene, spec, "pallas", 16, repair_k=64, **kw), loc, 1)
    return {**_gathered("b", b), **_gathered("r", r), "c_b": c_b,
            "c_r": c_r, "n_start": int(state.n_active())}


def case_fast_demote(case: str) -> dict:
    """Constant-heal demotion of the audited advance on the jet, 12-step
    dispatches, re-probing every 2 (the reference test's monkeypatch):
    mode and cumulative heals after each of five dispatches, the jet
    calmed (v = 0) before the fourth."""
    from sph_tpu_torch import step as step_mod

    scene, spec, state, loc = _fast_start("jet")
    saved = step_mod.PERSTEP_REPROBE_EVERY
    step_mod.PERSTEP_REPROBE_EVERY = 2
    try:
        adv = decomp.make_audited_spatial_advance(
            scene, spec, steps_per_dispatch=12, sort_every=4,
            slot_resident=True)
        modes, heals = [adv.mode], [adv.healed]
        for k in range(5):
            if k == 3:
                loc = loc.replace(v=loc.v * 0.0)
            loc = adv(loc)
            modes.append(adv.mode)
            heals.append(adv.healed)
    finally:
        step_mod.PERSTEP_REPROBE_EVERY = saved
    return {**_gathered("m", loc), "modes": np.array(modes),
            "heals": np.array(heals), "n_start": int(state.n_active())}


def case_fast_audited(case: str) -> dict:
    """The audited advance's default on the slot-resident fast path."""
    scene, spec, state, loc = _fast_start("wide")
    adv = decomp.make_audited_spatial_advance(
        scene, spec, steps_per_dispatch=16, sort_every=4, slot_resident=True)
    out = adv(loc)
    return {**_gathered("m", out), "n_start": int(state.n_active()),
            "counts": np.array([adv.healed, adv.repaired, adv.rebuilds]),
            "mode": np.array(adv.mode)}


def case_run_fast(case: str) -> dict:
    """run(shards=, sort_every=4, slot_resident=True) with a remainder
    dispatch that keeps the fast path (20 = 2·8 + 4) and one that runs
    per step (18 = 2·8 + 2), against the single-device runs."""
    scene = port.preset(RUN_SCENE)
    res = {}
    for n in (20, 18):
        kw = dict(method="pallas", steps_per_dispatch=9, sort_every=4,
                  slot_resident=True, device=CPU)
        frames = []
        out = port.run(scene, n, shards=dist.get_world_size(),
                       frame_callback=lambda s: frames.append(int(s.step)),
                       **kw)
        res.update({f"m{n}_{k}": v for k, v in _np(out).items()})
        res[f"frames{n}"] = np.array(frames)
        if dist.get_rank() == 0:
            ref = port.run(scene, n, **kw)
            res.update({f"ref{n}_{k}": v for k, v in _np(ref).items()})
    return res


# --- pencils ------------------------------------------------------------------


# suite "storage": auto-rebuild fast-path runs, each with the persistent
# block storage and with fresh storage (`slot_pass.FRESH_STORAGE`)
STORAGE_RUNS = {
    "storage_dart": ("dart", 2, dict(repair_k=64)),
    "storage_migrate": ("migrate", 3, {}),
    "storage_jet": ("jet", 1, {}),
}


def case_storage(case: str) -> dict:
    """One of STORAGE_RUNS twice: this rank's final local state bitwise
    equal between the two storages, the counters equal, and this rank's
    blocks by first pass (full, occupied, after a build, after a repair)
    on the persistent storage (one file a rank)."""
    from sph_tpu_torch import slot_pass

    name, n, opts = STORAGE_RUNS[case]
    scene, spec, _, loc = _fast_start(name)
    runs = []
    for fresh in (False, True):
        slot_pass.FRESH_STORAGE = fresh
        slot_pass.reset_launches()
        try:
            out, counts = _dispatches(decomp.make_spatial_advance(
                scene, spec, "pallas", 16, sort_every=4, slot_resident=True,
                auto_rebuild=True, **opts), loc, n)
        finally:
            slot_pass.FRESH_STORAGE = False
        runs.append((out, counts, dict(slot_pass.BLOCKS)))
    (a, c_a, blocks), (b, c_b, _) = runs
    same = np.array_equal(c_a, c_b) and all(
        torch.equal(getattr(a, k).contiguous().view(torch.int32),
                    getattr(b, k).contiguous().view(torch.int32))
        for k in ("x", "v", "acc", "rho", "p")) and all(
        torch.equal(getattr(a, k), getattr(b, k))
        for k in ("kind", "emit_step", "step"))
    return {"bitwise": np.array(same), "counts": c_a,
            "blocks": np.array([blocks[k] for k in (
                "full", "occupied", "after_build", "after_repair")])}


def _pencil_start(case):
    make, method, _, kw = PENCIL[case]
    scene = make(port)
    state = port.init(scene, device=CPU)
    if scene.params.integrator == "leapfrog":
        state = port.prime(scene, state, method, device=CPU)
    spec = decomp.PencilSpec.for_state(scene, state, *PENCIL_GRID, **kw)
    return scene, state, spec, decomp.pencil_shard_state(state, scene, spec,
                                                         CPU)


def case_pencil(case: str) -> dict:
    """The first step alone (make_pencil_step), then one dispatch of the
    rest; the gathered state, the per-pencil active counts before and
    after, the spec's fields and this rank's lattice offset."""
    _, method, n_steps, _ = PENCIL[case]
    scene, state, spec, loc = _pencil_start(case)
    before = _per_slab(loc)
    loc, first = decomp.make_pencil_step(scene, spec, method)(loc)
    loc, worst = decomp.make_pencil_advance(scene, spec, method,
                                            n_steps - 1)(loc)
    worst = torch.maximum(worst, first)
    grid = decomp.neighbors.GridSpec.for_pencil(
        scene, {spec.axis1: spec.w1, spec.axis2: spec.w2})
    ci = decomp._pencil_faces(scene, spec, grid)[1]
    offsets = decomp.comm.all_gather(torch.tensor([ci], dtype=torch.int64))
    return {**_gathered("m", loc), "worst": np.int64(worst),
            "before": before, "after": _per_slab(loc),
            "n_start": int(state.n_active()),
            "spec": np.array([str(dataclasses.astuple(spec))]),
            "ci_offsets": offsets.numpy()}


def case_pencil_overflow(_case: str) -> dict:
    """Ghost buffers of 8: every rank raises SpatialCapOverflow from the
    same dispatch, and the group stays usable."""
    scene, _, spec, _ = _pencil_start("pencil_grid")
    spec = dataclasses.replace(spec, cap_ghost=8)
    state = port.init(scene, device=CPU)
    loc = decomp.pencil_shard_state(state, scene, spec, CPU)
    adv = decomp.make_audited_pencil_advance(scene, spec, "grid", 5)
    try:
        adv(loc)
        raised = ""
    except decomp.SpatialCapOverflow as e:
        raised = str(e)
    total = decomp.comm.all_reduce_sum(torch.ones((), dtype=torch.int32))
    return {"raised": np.array(raised), "after": total.numpy()}


def case_pencil_run(case: str) -> dict:
    """run(shards=(2, 2)) for 13 steps in dispatches of 5, with a frame
    callback, and on rank 0 the single-device run."""
    scene = port.preset(PENCIL_RUN_SCENE)
    frames = []
    kw = dict(method="grid", steps_per_dispatch=5, device=CPU)
    out = port.run(scene, 13, shards=PENCIL_GRID,
                   frame_callback=lambda s: frames.append(int(s.step)), **kw)
    res = {**{f"m_{k}": v for k, v in _np(out).items()},
           "frames": np.array(frames)}
    if dist.get_rank() == 0:
        ref = port.run(scene, 13, **kw)
        res.update({f"ref_{k}": v for k, v in _np(ref).items()})
    return res


SUITES = {
    "world": {
        **{c: case_dp for c in ("dp_euler", "dp_leapfrog", "dp_fields")},
        **{c: case_spatial for c in SPATIAL},
        "overflow": case_overflow,
    },
    "run": {
        "run": case_run,
        "run_packed_rows": case_run_packed_rows,
        "run_elastic": case_run_elastic,
        "run_pallas": case_run_pallas,
        "run_fast": case_run_fast,
    },
    "fast": {
        "fast_reuse": case_fast_reuse,
        "fast_forced": case_fast_forced,
        **{c: case_fast_auto for c in AUTO_RUNS},
        **{c: case_fast_classic for c in ("migrate", "emit", "axis1")},
        "heal": case_fast_heal,
        "one_rank": case_fast_heal,
        "emit_repair": case_fast_emit_repair,
        "demote": case_fast_demote,
        "audited": case_fast_audited,
    },
    "storage": {c: case_storage for c in STORAGE_RUNS},
    "pencil": {
        **{c: case_pencil for c in PENCIL},
        "pencil_overflow": case_pencil_overflow,
        "pencil_run": case_pencil_run,
    },
}
PER_RANK = {"overflow", "one_rank", "pencil_overflow", *STORAGE_RUNS}


def spawn(suite: str, world: int, out: Path) -> list:
    """Start the `world` ranks of `suite` writing into `out`; each rank's
    output goes to `out/rank<r>.log`."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root), "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(world):
        log = open(out / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), suite, str(r),
             str(world), str(out / "store"), str(out)],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def join(procs: list, out: Path, timeout: float = 300.0) -> dict:
    """Wait for the ranks (killing all at the timeout) and return
    {case: npz arrays}; raises with the ranks' logs if one failed."""
    deadline = time.monotonic() + timeout
    codes = []
    try:
        for proc, _ in procs:
            try:
                codes.append(proc.wait(max(deadline - time.monotonic(), 1)))
            except subprocess.TimeoutExpired:
                codes.append("timeout")
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if any(c != 0 for c in codes):
        logs = "\n".join((out / f"rank{r}.log").read_text()[-4000:]
                         for r in range(len(procs)))
        raise RuntimeError(f"ranks ended with {codes}:\n{logs}")
    return {f.stem: dict(np.load(f)) for f in out.glob("*.npz")}


def main(argv) -> int:
    suite, rank, world, store, out = argv
    rank, world = int(rank), int(world)
    out = Path(out)
    torch.set_num_threads(1)
    dist.init_process_group(
        decomp.comm.backend_for(CPU), store=dist.FileStore(store, world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    try:
        for case, fn in SUITES[suite].items():
            t0 = time.perf_counter()
            res = fn(case)
            print(f"{case}: {time.perf_counter() - t0:.1f} s", file=sys.stderr,
                  flush=True)
            if case in PER_RANK:
                np.savez(out / f"{case}_r{rank}.npz", **res)
            elif rank == 0:
                np.savez(out / f"{case}.npz", **res)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
