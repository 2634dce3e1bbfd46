"""Throughput table and regression guard of the port (port of
`bench/bench_step.py`, whose `main()` is the body of the reference
command line's `bench` subcommand).

    python -m sph_tpu_torch.cli bench                   # every row, on the card
    python -m sph_tpu_torch.cli bench --only dam3d_100k --steps 40
    python -m sph_tpu_torch.cli bench --assert-floor    # exit 1 below a floor
    python -m sph_tpu_torch.cli bench --device cpu --only tutorial2d
    python -m sph_tpu_torch.bench_step --profile DIR    # + a trace a row

Each row of `CONFIGS` runs one (preset, method) at the preset's full size
and prints `{config}/{method}  n=...  ms/step  psteps/s`, then the rows
as one JSON list (`config`, `method`, `n`, `particle_steps_per_s`,
`s_per_step`).  A row below its floor in `FLOORS` is flagged `REGRESSION`
whatever the device, and `--assert-floor` then exits 1.  A row that raises
prints `UNAVAILABLE: <exception>` and the table goes on, as in the
reference: the two `@settled` rows read checkpoints that are made on
demand and not committed (`bench/.settled_1m_3000.npz`,
`bench/.settled_emitters3d.npz`, by `python -m
sph_tpu_torch.make_settled_state`), and without them they say
`UNAVAILABLE: FileNotFoundError`.  The device is `--device` (default
`cuda`): with no card the command exits 1 with one line, and it runs on
the CPU (the kernels' plain versions) only when `--device cpu` asks.

Timing (`timed_chain`): after a warm dispatch, a pilot window of one
dispatch sizes a chain of at most 64 dispatches holding about
`CHAIN_TARGET_S` of work; each of `repeats` windows runs the chain and
ends with one checksum, `float(x.sum(dtype=float32))`, a copy to the host
that waits for the card, and the best window over its chain length is the
time of a dispatch.  The rows' violation counts stay on the device until
the timing is over, so no window holds more than its one fetch, except
what the audited advances fetch themselves: that is part of the policy.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

import torch

from sph_tpu_torch import comm, decomp, diagnostics
from sph_tpu_torch.make_settled_state import settled_path
from sph_tpu_torch.params import preset
from sph_tpu_torch.platform import (
    add_device_flag,
    entry_device,
    resolve_device,
)
from sph_tpu_torch.state import init
from sph_tpu_torch.step import (
    default_repair_k,
    default_skin,
    make_advance,
    make_audited_advance,
    packed_fits,
    prime,
)

# Trailing-edge floors (particle-steps/s) for --assert-floor: the median
# of this bench's own runs in two calls on an NVIDIA H100 80GB HBM3 at
# 700.00 W (`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`),
# at the default --steps 100, minus ~30%, the slack of the reference's
# floors.  Keys are the reference's; its values are TPU figures and none is
# kept.  The two @settled rows start from the checkpoints that
# `make_settled_state` makes (their floors: four runs in one call, each
# its own process, after one make of the checkpoints).  emitters3d starts
# empty and its n follows the steps a row's chain runs (272-476
# particles), so its rate does too; emitters3d@settled goes on filling
# from 20,024 (21,212-21,824 in those runs).
FLOORS = {
    ("tutorial2d", "naive"): 8.5e+05,                 # median 1.22e+06 of 4
    ("dam2d_10k", "grid"): 1.7e+06,                   # median 2.42e+06 of 4
    ("dam2d_10k", "pallas"): 3.4e+06,                 # median 4.83e+06 of 4
    # median 7.56e+06 of 3: one at --steps 100 and two at --steps 8; at 100
    # the other three runs raised a skin violation: their chains ran the
    # flow past the step where it first outruns the skin (chip_smoke.py's
    # bench phase finds it), and the row refuses a number, as the
    # reference's does
    ("dam2d_10k", "resident4"): 5.3e+06,
    ("dam2d_10k", "resident4auto"): 7.6e+06,          # median 1.08e+07 of 4
    ("dam2d_10k", "auto8"): 5.3e+06,                  # median 7.5e+06 of 4
    ("dam3d_100k", "grid"): 1.3e+06,                  # median 1.9e+06 of 4
    ("dam3d_100k", "pallas"): 3e+07,                  # median 4.21e+07 of 4
    ("dam3d_100k", "resident4"): 4.6e+07,             # median 6.56e+07 of 4
    ("dam3d_100k", "resident4auto"): 3.2e+07,         # median 4.5e+07 of 4
    ("dam3d_100k", "auto8"): 3.2e+07,                 # median 4.58e+07 of 4
    ("dam3d_100k", "spatial-resident4"): 2.7e+07,     # median 3.81e+07 of 4
    ("dam3d_100k", "spatial-resident4auto"): 2.8e+07, # median 3.97e+07 of 4
    ("dam3d_100k", "pencil"): 8.1e+06,                # median 1.16e+07 of 4
    ("splash3d_1m", "pallas"): 2.4e+08,               # median 3.37e+08 of 4
    ("splash3d_1m", "resident4"): 1.7e+08,            # median 2.36e+08 of 4
    ("splash3d_1m", "resident4auto"): 1.4e+08,        # median 2.02e+08 of 4
    ("splash3d_1m", "auto8"): 1.3e+08,                # median 1.9e+08 of 4
    ("splash3d_1m", "spatial-resident4"): 1.7e+08,    # median 2.41e+08 of 4
    ("splash3d_1m", "spatial-resident4auto"): 1.5e+08,  # median 2.12e+08 of 4
    ("splash3d_1m@settled", "resident4auto"): 2.4e+08,  # median 3.39e+08 of 4
    ("emitters3d", "pallas"): 1.4e+05,                # median 2.04e+05 of 4
    ("emitters3d@settled", "resident4auto"): 3.2e+07,   # median 4.5e+07 of 4
    ("vortex2d", "audited4"): 7.6e+06,                # median 1.08e+07 of 4
}

# method "resident4" = pallas + sort_every=4 + slot-resident blocks;
# "resident4auto" the same with auto-rebuild and the policy's repair_k
# and packed rows; "auto8" the cap-8 policy; "spatial-resident4[auto]"
# the slab fast path on one rank; "pencil" a 1x1 pencil; "audited4" the
# audited policy of run()'s default.
CONFIGS = [
    ("tutorial2d", "naive"),
    ("tutorial2d", "grid"),
    ("tutorial2d", "pallas"),
    ("dam2d_10k", "grid"),
    ("dam2d_10k", "pallas"),
    ("dam2d_10k", "resident4"),
    ("dam2d_10k", "resident4auto"),
    ("dam2d_10k", "auto8"),
    ("dam3d_100k", "grid"),
    ("dam3d_100k", "pallas"),
    ("dam3d_100k", "resident4"),
    ("dam3d_100k", "resident4auto"),
    ("dam3d_100k", "auto8"),
    ("dam3d_100k", "spatial-resident4"),
    ("dam3d_100k", "spatial-resident4auto"),
    ("dam3d_100k", "pencil"),
    ("splash3d_1m", "pallas"),
    ("splash3d_1m", "resident4"),
    ("splash3d_1m", "resident4auto"),
    ("splash3d_1m@settled", "resident4auto"),
    ("splash3d_1m", "auto8"),
    ("splash3d_1m", "spatial-resident4"),
    ("splash3d_1m", "spatial-resident4auto"),
    ("emitters3d", "pallas"),
    ("emitters3d@settled", "resident4auto"),
    ("vortex2d", "audited4"),
]

#: The reference bench's dispatch size: its Pallas rows run at most this
#: many steps a dispatch (bench/bench_step.py:124, 167, 241, 266, 333), so
#: each row here does the work of the reference's row.  It is no rule of
#: `run()`, whose dispatches are not clamped (ROADMAP Queue 3 item 4).
BENCH_DISPATCH = 100

#: Seconds of work a timed window holds (see `timed_chain`).
CHAIN_TARGET_S = 1.0


def _pallas_steps(steps: int, sort_every: int = 1) -> int:
    """A Pallas row's dispatch: at most BENCH_DISPATCH steps, rounded down
    to a multiple of sort_every (at least one block)."""
    steps = min(steps, BENCH_DISPATCH)
    if sort_every > 1:
        steps = max(steps - steps % sort_every, sort_every)
    return steps


def _fresh(scene, method: str, device):
    """init, and the leapfrog prime with `method`."""
    state = init(scene, device=device)
    if scene.params.integrator == "leapfrog":
        state = prime(scene, state, method=method, device=device)
    return state


def checksum(state) -> float:
    return float(torch.sum(state.x, dtype=torch.float32))


def timed_chain(one, state, repeats: int = 3, target_s: float | None = None):
    """Best-of-`repeats` timed windows of chained dispatches.

    `one(state) -> (state, aux)` runs one dispatch; `aux` (a device scalar
    or None) is returned for the caller to check after the timing.  A
    pilot window of one dispatch sizes the chain to hold about `target_s`
    (default CHAIN_TARGET_S) of work, at most 64 dispatches; each window
    runs the chain and fetches one checksum, and its time is divided by
    the chain length.  A row whose dispatch already takes longer keeps
    chain 1, and its pilot counts as one of the windows.

    Returns (best seconds a dispatch, state, auxes)."""
    if target_s is None:
        target_s = CHAIN_TARGET_S
    auxes = []
    t0 = time.perf_counter()
    state, aux = one(state)
    checksum(state)
    pilot = time.perf_counter() - t0
    auxes.append(aux)
    chain = int(min(max(-(-target_s // max(pilot, 1e-4)), 1), 64))
    best = pilot if chain == 1 else float("inf")
    if chain == 1:
        repeats -= 1
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(chain):
            state, aux = one(state)
            auxes.append(aux)
        checksum(state)
        best = min(best, (time.perf_counter() - t0) / chain)
    return best, state, auxes


def _check_clean(counts, what: str) -> None:
    for c in counts:
        if c is not None and int(c):
            raise RuntimeError(f"{int(c)} {what}")


def bench_spatial(name, k, steps, repeats=3, auto=False, device=None):
    """The slab fast path on a one-rank process group (NCCL on the card,
    gloo on the CPU) that the row makes and destroys: what the slab
    machinery costs on one device.  `auto` is the auto-rebuild resident
    form.  Returns (psteps/s, s/step, n)."""
    device = resolve_device(device)
    scene = preset(name)
    steps = _pallas_steps(steps, k)
    state = _fresh(scene, "pallas", device)
    with comm.joined(comm.backend_for(device), alone=True):
        spec = decomp.SpatialSpec.for_state(
            scene, state, 1, skin=default_skin(scene, k))
        loc = decomp.spatial_shard_state(state, scene, spec, device)
        adv = decomp.make_spatial_advance(
            scene, spec, method="pallas", steps_per_dispatch=steps,
            sort_every=k, slot_resident=True, auto_rebuild=auto)

        def one(st):
            out = adv(st)
            return out[0], out[1]

        loc, worst0 = one(loc)
        checksum(loc)
        _check_clean([worst0], "spatial cap/skin violations")
        best, loc, worsts = timed_chain(one, loc, repeats)
        _check_clean(worsts, "spatial cap/skin violations")
        n = int(decomp.spatial_gather_state(loc).n_active())
    return n * steps / best, best / steps, n


def bench_pencil(name, steps, repeats=3, device=None):
    """A 1x1 pencil on a one-rank process group: pencils step per step,
    so against the per-step pallas row this is what the two-hop ghost
    machinery costs on one device."""
    device = resolve_device(device)
    scene = preset(name)
    steps = _pallas_steps(steps)
    state = _fresh(scene, "pallas", device)
    with comm.joined(comm.backend_for(device), alone=True):
        spec = decomp.PencilSpec.for_state(scene, state, 1, 1)
        loc = decomp.pencil_shard_state(state, scene, spec, device)
        adv = decomp.make_audited_pencil_advance(
            scene, spec, method="pallas", steps_per_dispatch=steps)
        loc = adv(loc)
        checksum(loc)
        best, loc, _ = timed_chain(lambda st: (adv(st), None), loc, repeats)
        n = int(decomp.spatial_gather_state(loc).n_active())
    return n * steps / best, best / steps, n


def _bench_audited(name, steps, repeats, sort_every, device, **kw):
    scene = preset(name)
    steps = _pallas_steps(steps, sort_every)
    state = _fresh(scene, "pallas", device)
    adv = make_audited_advance(
        scene, "pallas", steps, sort_every=sort_every, slot_resident=True,
        device=device, **kw)
    state = adv(state)
    checksum(state)
    best, state, _ = timed_chain(lambda st: (adv(st), None), state, repeats)
    n = int(state.n_active())
    return n * steps / best, best / steps, n


def bench_auto8(name, steps, repeats=3, sort_every=4, device=None):
    """The cap-8 policy: a cap-8 lattice while the flow fits, overflow
    blocks healed exactly, the default cap once outgrown."""
    return _bench_audited(name, steps, repeats, sort_every,
                          resolve_device(device), adaptive_cap=True)


def bench_audited(name, steps, repeats=3, sort_every=4, device=None):
    """The audited policy of the production default: unlike the resident
    rows, which raise on a violation, it heals, re-runs and demotes in the
    timed windows (vortex2d's stir outruns the skin, so the policy demotes
    to per step and the repeats time the demoted regime)."""
    return _bench_audited(name, steps, repeats, sort_every,
                          resolve_device(device))


def bench_one(name, method, steps, repeats=3, device=None):
    """One row: (particle-steps/s, s/step, n) of `method` at preset
    `name` (or its settled checkpoint, `name@settled`)."""
    device = resolve_device(device)
    if method == "pencil":
        return bench_pencil(name, steps, device=device)
    if method.startswith("audited"):
        return bench_audited(name, steps, repeats,
                             sort_every=int(method[len("audited"):]),
                             device=device)
    if method.startswith("spatial-resident"):
        tail = method[len("spatial-resident"):]
        auto = tail.endswith("auto")
        return bench_spatial(name, int(tail[:-4] if auto else tail), steps,
                             auto=auto, device=device)
    if method == "auto8":
        return bench_auto8(name, steps, repeats, device=device)
    if name.endswith("@settled"):
        # the settled maker's table, as the reference bench reads it
        state, scene = diagnostics.load_checkpoint(
            settled_path(name[: -len("@settled")]), device=device)
    else:
        scene = preset(name)
        state = init(scene, device=device)
    kw = {}
    base = method
    if method.startswith("resident"):
        tail = method[len("resident"):]
        base = "pallas"
        if tail.endswith("auto"):
            # the shipped policy: repair_k and the packed-row probe
            # resolved as make_audited_advance resolves them
            k = int(tail[:-4])
            packed = bool(scene.emitters) and packed_fits(scene, state, k)
            kw = dict(sort_every=k, slot_resident=True, auto_rebuild=True,
                      packed_rows=packed,
                      repair_k=default_repair_k(scene, auto=True,
                                                packed_rows=packed))
        else:
            kw = dict(sort_every=int(tail), slot_resident=True)
    if base == "pallas":
        steps = _pallas_steps(steps, kw.get("sort_every", 1))
    if scene.params.integrator == "leapfrog":
        state = prime(scene, state, method=base, device=device)
    adv = make_advance(scene, base, steps_per_dispatch=steps, device=device,
                       **kw)

    def one(st):
        if kw:
            out = adv(st)
            return out[0], out[1]
        return adv(st), None

    state, viol0 = one(state)
    checksum(state)
    _check_clean([viol0], "skin/cap violations")
    best, state, viols = timed_chain(one, state, repeats)
    _check_clean(viols, "skin/cap violations")
    n = int(state.n_active())
    return n * steps / best, best / steps, n


def _profiled(path: str, fn, device):
    """fn() under torch.profiler (the card's kernels too when `device` is
    one), its trace written to `path` as Chrome JSON."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
    prof.export_chrome_trace(path)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sph-tpu-torch bench")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--profile", default=None,
                    help="directory for a torch.profiler trace of each row")
    ap.add_argument("--assert-floor", action="store_true")
    ap.add_argument("--only", default=None, help="substring filter")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    if device is None:
        return 1
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)

    failures = []
    results = []
    for name, method in CONFIGS:
        tag = f"{name}/{method}"
        if args.only and args.only not in tag:
            continue
        row = functools.partial(bench_one, name, method, args.steps,
                                device=device)
        try:
            if args.profile:
                ps, per_step, n = _profiled(
                    os.path.join(args.profile, f"{name}_{method}.json"), row,
                    device)
            else:
                ps, per_step, n = row()
        except Exception as e:  # noqa: BLE001 — a row's failure is its line
            print(f"{tag:28s} UNAVAILABLE: {type(e).__name__}: {str(e)[:80]}")
            continue
        line = (f"{tag:28s} n={n:8d}  {per_step*1e3:9.3f} ms/step  "
                f"{ps:13.3e} psteps/s")
        floor = FLOORS.get((name, method))
        if floor and ps < floor:
            line += f"  REGRESSION (< {floor:.2e})"
            failures.append(tag)
        print(line, flush=True)
        results.append({"config": name, "method": method, "n": n,
                        "particle_steps_per_s": ps, "s_per_step": per_step})
    print(json.dumps(results))
    if args.assert_floor and failures:
        print(f"FAILED floors: {failures}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
