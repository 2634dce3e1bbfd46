"""The 1M splash soak under spatial decomposition (port of
`bench/soak_spatial.py`).

It checks the decomposed production path, `make_audited_spatial_advance`
with the auto-rebuild resident fast path, through the collapse → impact →
settle arc as `soak_1m` checks the single-device one: skin and cap audits
absorbed by the exact re-runs, an elastic re-spec when the flow outgrows a
static buffer (`SpatialCapOverflow`: gather, re-spec, re-shard, run the
dispatch again), every particle kept at every probe, and the whole-run
soak-average.

    python -m sph_tpu_torch.soak_spatial [n_steps=2000] [shards=1]
    torchrun --nproc-per-node N -m sph_tpu_torch.soak_spatial 2000 N

A rank is a process: `shards` ranks run under `torchrun --nproc-per-node
shards` (NCCL, each rank on cuda:LOCAL_RANK; `--device cuda:K` puts every
rank on card K over gloo; `--device cpu` gloo on the host), and one rank
also runs alone, in a process group of its own.  Every rank issues the
same collectives in the same order; rank 0 prints.  Without a card the
command exits 1 with one line.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch
import torch.distributed as dist

from sph_tpu_torch import comm, decomp, diagnostics
from sph_tpu_torch.params import Scene, preset
from sph_tpu_torch.platform import add_device_flag
from sph_tpu_torch.state import init
from sph_tpu_torch.step import default_skin, prime

SPD = 100


def _group(shards: int, device):
    """The process group the soak runs in: the initialized one (of
    `shards` ranks), or for one shard a group of this process alone."""
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != shards:
            raise ValueError(
                f"soak_spatial(shards={shards}) in a process group of "
                f"{dist.get_world_size()} ranks")
        return contextlib.nullcontext()
    if shards != 1:
        raise ValueError(
            f"soak_spatial(shards={shards}) needs a process group of "
            f"{shards} ranks, one process each: start it under `torchrun "
            f"--nproc-per-node {shards}`")
    return comm.joined(comm.backend_for(device), alone=True)


def soak(n_steps: int = 2000, shards: int = 1, device=None, *,
         scene: Scene | None = None) -> dict:
    """Run the soak (splash3d_1m, or `scene`) on `shards` slabs and return,
    on every rank, its counters and health: the soak-average rate and ms a
    step over the timed window, the elastic recoveries (each with its step
    and the host seconds of its gather, re-spec and re-shard), healed
    blocks, repaired blocks and rebuilds over every advance, the final
    mode, the probes (each with its active count), finiteness and the
    card's peak memory.  Prints the reference's lines on rank 0.  Raises
    AssertionError when a probe counts a particle lost."""
    dev = comm.rank_device(device)
    scene = scene if scene is not None else preset("splash3d_1m")
    with _group(shards, dev):
        return _soak(n_steps, shards, dev, scene)


def _soak(n_steps, shards, dev, scene) -> dict:
    say = print if comm.rank() == 0 else (lambda *a, **k: None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = init(scene, device=dev)
    state = prime(scene, state, method="pallas", device=dev)
    n = int(state.n_active())
    skin = default_skin(scene, 4)

    def build(st):
        spec = decomp.SpatialSpec.for_state(scene, st, shards, skin=skin)
        loc = decomp.spatial_shard_state(st, scene, spec, dev)
        adv = decomp.make_audited_spatial_advance(
            scene, spec, "pallas", steps_per_dispatch=SPD, sort_every=4,
            slot_resident=True)
        return loc, adv

    loc, adv = build(state)
    counters = {"healed": 0, "repaired": 0, "rebuilds": 0}

    def carry(a):
        for k in counters:
            counters[k] += getattr(a, k)

    say(f"spatial soak: n={n}, {n_steps} steps, shards={shards}",
        flush=True)
    loc = adv(loc)  # warm dispatch outside the timed loop
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    done = SPD
    recoveries = []
    probes = []
    t0 = time.perf_counter()
    while done < n_steps:
        try:
            loc = adv(loc)
        except decomp.SpatialCapOverflow as e:
            say(f"elastic recovery at step {done}: {e}", flush=True)
            carry(adv)
            t_re = time.perf_counter()
            loc, adv = build(decomp.spatial_gather_state(loc))
            recoveries.append({"step": done,
                               "respec_s": time.perf_counter() - t_re})
            loc = adv(loc)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        done += SPD
        if done % 500 == 0:
            merged = decomp.spatial_gather_state(loc)
            mx = float(torch.max(torch.abs(merged.v)))
            rm = diagnostics.active_rho_mean(merged, floor=1)
            n_act = int(merged.n_active())
            wall = time.perf_counter() - t0
            probes.append({"step": done, "n_act": n_act, "max_abs_v": mx,
                           "rho_mean": rm, "wall_s": wall})
            say(f"step {done:5d}  wall {wall:8.1f}s  n_act={n_act} "
                f"max|v|={mx:7.1f} rho_mean={rm:8.1f}", flush=True)
            assert n_act == n, f"lost particles: {n_act} != {n}"
    wall = time.perf_counter() - t0
    timed = done - SPD
    merged = decomp.spatial_gather_state(loc)
    ok = bool(torch.all(torch.isfinite(merged.x)))
    carry(adv)
    say(f"SPATIAL SOAK RESULT: {timed} timed steps in {wall:.1f}s → "
        f"{n * timed / wall:.3e} particle-steps/s soak-average "
        f"({wall / timed * 1e3:.1f} ms/step); "
        f"recoveries={len(recoveries)} "
        f"healed_blocks={counters['healed']} finite={ok}", flush=True)
    assert ok
    return {"n": n, "shards": shards, "steps": done, "timed_steps": timed,
            "timed_s": wall, "psteps_per_s": n * timed / wall,
            "ms_per_step": wall / timed * 1e3, "recoveries": recoveries,
            **counters, "mode": adv.mode, "probes": probes, "finite": ok,
            "n_final": int(merged.n_active()),
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
            "state": merged}


def main(argv=None) -> int:
    from sph_tpu_torch.cli import _rank_device

    ap = argparse.ArgumentParser(prog="python -m sph_tpu_torch.soak_spatial")
    ap.add_argument("n_steps", nargs="?", type=int, default=2000)
    ap.add_argument("shards", nargs="?", type=int, default=1)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    world = os.environ.get("WORLD_SIZE")
    if int(world or 1) != args.shards:
        launched = ("as one process" if world is None
                    else f"with {world} processes")
        print(f"shards={args.shards} needs {args.shards} ranks, one process "
              f"each, and was started {launched}: launch it with `torchrun "
              f"--nproc-per-node {args.shards} -m sph_tpu_torch.soak_spatial"
              f" ...`", file=sys.stderr)
        return 2
    try:
        device, backend = _rank_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with comm.joined(backend, alone=world is None):
        soak(args.n_steps, args.shards, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
