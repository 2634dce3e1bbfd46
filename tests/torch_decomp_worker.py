"""One rank of a gloo world for the decomposition tests
(`test_torch_decomp_world.py`, `test_torch_decomp_run.py`).

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


def straddle(m):
    """A block across the face at x = 800 of two slabs: its ghost band is
    full from the first step."""
    return pool(m, seed=68, block=((700.0, 20.0), (900.0, 160.0)),
                velocity=(0.0, 0.0))


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
    },
}
PER_RANK = {"overflow"}


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
