"""Command line of the port (port of `sph_tpu/cli.py`): `run`, `record` and
`presets`.

    python -m sph_tpu_torch.cli run dam3d_100k --sort-every 4 --resident --adaptive-cap
    python -m sph_tpu_torch.cli record dam2d_10k --frames 10 --out movie.apng
    python -m sph_tpu_torch.cli presets

`run` advances a preset (or a scene .json, or a checkpoint with
`--resume`) frame by frame and writes one line of `metrics.jsonl` per
frame into `--out`, watchdog-checked, with optional frame PNGs
(`--render`) and checkpoints; `record` writes one animated PNG.  The flags
and defaults are the reference's.  The device is `--device` (default
`cuda`): with no card the command exits non-zero with one line, and it
never carries on on the CPU unless `--device cpu` asks for it.
Contradictory flags exit 2 with one line before the device is touched.
The reference's `bench` subcommand drives a JAX benchmark folder and has
no counterpart here.

A decomposed run or record (`--shards N` slabs, `--shards N1xN2` pencils)
is one process per rank:

    torchrun --nproc-per-node 4 -m sph_tpu_torch.cli run dam3d_100k --shards 2x2

(`--shards 1` also runs as a plain command, in a one-rank group of its
own).  Devices and backend: `--device cuda` puts each rank on
`cuda:LOCAL_RANK` over NCCL; `--device cuda:K` puts every rank on card K,
over gloo when the machine runs more than one rank (NCCL takes one rank a
card), the computation staying on the card; `--device cpu` runs gloo.
Every rank takes part in every collective; only rank 0 writes
`metrics.jsonl`, frames, checkpoints and the APNG, prints the per-frame
line, and reads the `--interact` file, whose commands it broadcasts to
the others once a frame.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
import time

from sph_tpu_torch import diagnostics, render
from sph_tpu_torch.params import (
    ForceField,
    calibrate,
    preset,
    preset_names,
    scene_from_json,
)
from sph_tpu_torch.platform import resolve_device
from sph_tpu_torch.state import init
from sph_tpu_torch.state import spawn as spawn_particles
from sph_tpu_torch.step import make_audited_advance, prime


class _Interactor:
    """Headless live-interaction hook: between frames, consume appended
    JSON lines from a command file.  Commands:

      {"force_field": {"pos": [x, y(, z)], "strength": S,
                       "radius": R, "duration_steps": D}}
          — a drag/push probe starting NOW (a step-scheduled ForceField;
            the advance is rebuilt once per interaction)
      {"spawn": {"pos": [x, y(, z)], "n": N, "velocity": [vx, ...],
                 "radius": R}}
          — inject up to N particles around pos NOW (claims
            never-activating slots — see state.spawn)
      {"pause": true} / {"resume": true}
      {"reset": true}
          — re-seed the scene from scratch; the step clock restarts at 0,
            so step-scheduled emitters and force fields re-fire"""

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self.paused = False
        # state-mutating commands, FILE ORDER preserved: ("spawn", kwargs)
        # or ("reset", None) — reset-then-spawn must keep the spawn, and
        # spawn-then-reset must discard it, exactly as typed
        self.events: list[tuple[str, dict | None]] = []
        self._spawn_seq = 0

    def take_events(self) -> list[tuple[str, dict | None]]:
        """Drain pending state-mutating commands in file order."""
        out, self.events = self.events, []
        return out

    def poll(self, scene, step_now: int):
        """→ (scene, changed)."""
        try:
            with open(self.path) as fh:
                fh.seek(self.offset)
                lines = fh.read()
                self.offset = fh.tell()
        except FileNotFoundError:
            return scene, False
        changed = False
        for line in lines.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                cmd = json.loads(line)
            except ValueError:
                print(f"interact: bad JSON line ignored: {line!r}",
                      file=sys.stderr)
                continue
            if cmd.get("pause"):
                self.paused = True
            if cmd.get("resume"):
                self.paused = False
            if cmd.get("reset"):
                self.events.append(("reset", None))
            ff = cmd.get("force_field")
            if ff:
                field = ForceField(
                    pos=tuple(float(c) for c in ff["pos"]),
                    strength=float(ff["strength"]),
                    radius=float(ff.get("radius", 64.0)),
                    start_step=step_now,
                    stop_step=step_now + int(ff.get("duration_steps", 200)),
                )
                scene = scene.replace(
                    force_fields=scene.force_fields + (field,)
                )
                changed = True
                print(f"interact: force field @{field.pos} "
                      f"until step {field.stop_step}", file=sys.stderr)
            sp = cmd.get("spawn")
            if sp:
                try:
                    req = {"pos": [float(c) for c in sp["pos"]],
                           "n": int(sp.get("n", 64))}
                    if "velocity" in sp:
                        req["velocity"] = [float(c) for c in sp["velocity"]]
                    if "radius" in sp:
                        req["radius"] = float(sp["radius"])
                    # vary the lattice jitter per spawn: two identical
                    # commands must not place bitwise-coincident particles
                    req["seed"] = int(sp.get("seed", self._spawn_seq))
                    self._spawn_seq += 1
                except (KeyError, TypeError, ValueError) as e:
                    print(f"interact: bad spawn command ignored ({e}): "
                          f"{line!r}", file=sys.stderr)
                    continue
                self.events.append(("spawn", req))
        return scene, changed


def _parse_shards(text) -> tuple[int, ...] | None:
    """`--shards` value: "0" → None (single device), "N" → 1-axis slabs,
    "N1xN2" → 2-axis pencils."""
    s = str(text).lower().strip()
    if "x" in s:
        n1, n2 = (int(p) for p in s.split("x", 1))
        if n1 < 1 or n2 < 1:
            raise ValueError(f"bad --shards {text!r}")
        return (n1, n2)
    n = int(s)
    if n < 0:
        raise ValueError(f"bad --shards {text!r}")
    return (n,) if n else None


class _UsageError(Exception):
    """Bad flag combination; the message goes to stderr, the exit code is 2."""


def _packed_rows_arg(args):
    """--packed-rows {auto,on,off} → None/True/False (step.run semantics)."""
    return {"auto": None, "on": True, "off": False}[args.packed_rows]


def _fresh_state(scene, method: str, device):
    """init + leapfrog prime: the one definition of "a fresh state ready to
    step with `method`", shared by startup and the live reset command."""
    state = init(scene, device=device)
    if scene.params.integrator == "leapfrog":
        state = prime(scene, state, method=method, device=device)
    return state


def _load_scene(name_or_path: str):
    """A preset name, or a path to a Scene .json (mass-calibrated)."""
    if name_or_path.endswith(".json"):
        with open(name_or_path) as fh:
            return calibrate(scene_from_json(fh.read()))
    return preset(name_or_path)


def _validate_fastpath_flags(args) -> None:
    """Reject contradictory fast-path flags with a usage error instead of
    a factory ValueError traceback (or a knob silently ignored off the
    resident path).  Called after _resolve_method: `--method auto` turns
    on the resident fast path, so these fire only on explicitly
    contradictory flags.  The --debug path ignores the reuse knobs by
    design (it prints a note), so it skips them here."""
    rk = args.repair_k if args.repair_k is not None else 0
    if rk < 0:
        raise _UsageError("--repair-k must be >= 0")
    if rk and args.strict_audit:
        raise _UsageError(
            "--repair-k needs the membership-relaxed audit; "
            "drop --strict-audit"
        )
    if getattr(args, "debug", False):
        return
    if args.resident and args.sort_every <= 1:
        raise _UsageError(
            "--resident requires --sort-every>1 (or leave --method auto)"
        )
    if args.sort_every > 1 and args.method != "pallas":
        raise _UsageError("--sort-every>1 requires --method pallas")
    if rk and not (args.resident and args.sort_every > 1):
        raise _UsageError(
            "--repair-k requires the resident fast path "
            "(--resident --sort-every>1, or leave --method auto)"
        )
    if args.adaptive_cap and not args.resident:
        raise _UsageError(
            "--adaptive-cap requires --resident (or leave --method auto)"
        )


def _resolve_method(args) -> None:
    """`--method auto` (the default) = the production default: pallas +
    4-step Verlet-skin reuse + slot-resident blocks with auto-rebuild.
    Explicit --sort-every/--resident flags are respected; --debug keeps
    the per-step checked path."""
    if args.method != "auto":
        return
    args.method = "pallas"
    if getattr(args, "debug", False):
        return
    if args.sort_every == 1:
        # an explicit --resident under auto keeps residency and still gets
        # the default block length; an explicit --sort-every is respected
        args.sort_every = 4
        args.resident = True


def _spf(args) -> int:
    """Steps a dispatch: --steps-per-frame, rounded down to a multiple of
    --sort-every (at least one block).  A frame is one dispatch: the
    reference's split of long pallas frames is a TPU limit."""
    spf = args.steps_per_frame
    if args.sort_every > 1 and not getattr(args, "debug", False):
        spf -= spf % args.sort_every
        spf = max(spf, args.sort_every)
    return spf


def _audited(args, scene, spf: int, device):
    return make_audited_advance(
        scene, args.method, spf, sort_every=args.sort_every,
        slot_resident=args.resident, adaptive_cap=args.adaptive_cap,
        membership_audit=not args.strict_audit, repair_k=args.repair_k,
        packed_rows=_packed_rows_arg(args), device=device,
    )


# ---------------------------------------------------------------------------
# Decomposed runs: one process per rank, under torchrun
# ---------------------------------------------------------------------------


def _lead() -> bool:
    """This process is rank 0, the one that writes and prints."""
    import torch.distributed as dist

    return dist.get_rank() == 0


def _note(msg: str) -> None:
    if _lead():
        print(msg, file=sys.stderr)


def _rank_device(arg: str):
    """(this rank's device, the process group's backend) by the rule of
    the module docstring.  Raises RuntimeError (one line) when the card
    asked for is not there."""
    import torch

    if arg == "cpu":
        return torch.device("cpu"), "gloo"
    dev = resolve_device(arg)
    backend = "nccl"
    if dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    elif int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1:
        backend = "gloo"
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"sph-tpu-torch: rank {os.environ.get('RANK', '0')} needs {dev}, "
            f"this machine has {torch.cuda.device_count()} card(s); run "
            f"fewer ranks a machine or pin one card with --device cuda:K")
    return dev, backend


def _decomposed(args) -> int:
    """`run|record --shards`: check the launch against the rank count, pick
    this rank's device and backend, join the process group (torchrun's
    env://, or a one-rank group of its own for `--shards 1` alone) and run
    the command in it; the group is destroyed on the way out."""
    import torch
    import torch.distributed as dist

    n_total = math.prod(args.shards)
    desc = "x".join(str(d) for d in args.shards)
    world = os.environ.get("WORLD_SIZE")
    if int(world or 1) != n_total:
        launched = ("as one process" if world is None
                    else f"with {world} processes")
        print(f"--shards {desc} needs {n_total} ranks, one process each, "
              f"and was started {launched}: launch it with `torchrun "
              f"--nproc-per-node {n_total} -m sph_tpu_torch.cli ...`",
              file=sys.stderr)
        return 2
    try:
        device, backend = _rank_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method="env://")
    try:
        _note(f"sph-tpu-torch: --shards {desc} on {n_total} rank(s), "
              f"{backend} backend, rank 0 on {device}")
        return args.fn(args, device)
    finally:
        dist.destroy_process_group()


def _decomp_setup(args, scene, device):
    """Shared by `run --shards` and `record --shards`: validate the flag
    set (a _UsageError, the same on every rank) and return (build,
    mesh_desc, n_total), where build(sc, st) -> (loc, adv) shards st
    over the ranks and makes the audited advance.  Pencils
    downgrade --sort-every/--resident/--repair-k to per step, with a
    note."""
    from sph_tpu_torch import decomp
    from sph_tpu_torch.step import default_skin

    dims = args.shards
    pencil = len(dims) == 2
    n_total = math.prod(dims)
    mesh_desc = "x".join(str(d) for d in dims)
    if getattr(args, "debug", False):
        raise _UsageError("--debug is not supported with --shards")
    if pencil and (args.sort_every > 1 or args.resident or args.repair_k):
        # the pencil path steps per step (slabs carry the fast path);
        # --method auto lands here too, downgraded with a note
        _note("note: pencil decomposition steps per-step; "
              "--sort-every/--resident/--repair-k are ignored")
        args.sort_every, args.resident, args.repair_k = 1, False, 0
    if args.sort_every > 1 and args.method != "pallas":
        raise _UsageError("--sort-every>1 requires --method pallas")
    if pencil:
        # resolve the default here so a collision with the default second
        # axis is a usage error, not a traceback out of build()
        if args.shard_axis2 is None:
            args.shard_axis2 = scene.params.dim - 1
        if args.shard_axis2 == args.shard_axis:
            raise _UsageError("--shard-axis2 must differ from --shard-axis")
    if args.adaptive_cap:
        _note("note: --adaptive-cap is single-chip only; ignored with "
              "--shards")
    if args.packed_rows != "auto":
        # the packed-row layout is single-device only; decomposed sparse
        # scenes run the slot layout
        _note("note: --packed-rows is single-chip only; ignored with "
              "--shards (slot layout used)")
    spf = _spf(args)
    skin = default_skin(scene, args.sort_every) if args.sort_every > 1 else 0.0

    def build(sc, st):
        if pencil:
            spec = decomp.PencilSpec.for_state(
                sc, st, dims[0], dims[1], axis1=args.shard_axis,
                axis2=args.shard_axis2)
            return (decomp.pencil_shard_state(st, sc, spec, device),
                    decomp.make_audited_pencil_advance(sc, spec, args.method,
                                                       spf))
        spec = decomp.SpatialSpec.for_state(sc, st, n_total,
                                            axis=args.shard_axis, skin=skin)
        return (decomp.spatial_shard_state(st, sc, spec, device),
                decomp.make_audited_spatial_advance(
                    sc, spec, args.method, spf, sort_every=args.sort_every,
                    slot_resident=args.resident,
                    membership_audit=not args.strict_audit,
                    repair_k=args.repair_k))

    return build, mesh_desc, n_total


def _advance_elastic(adv, loc, build, scene):
    """One dispatch; a SpatialCapOverflow (the flow outgrew the static
    buffers, raised on every rank together) re-specs from the gathered
    state and runs the dispatch again.  Returns (loc, adv)."""
    from sph_tpu_torch import decomp

    try:
        return adv(loc), adv
    except decomp.SpatialCapOverflow as e:
        _note(f"elastic recovery: {e}")
        loc, adv = build(scene, decomp.spatial_gather_state(loc))
        return adv(loc), adv


def _shared_commands(interactor, scene, step_now: int):
    """Rank 0 polls the --interact file (waiting out a pause) and
    broadcasts (scene, changed, events) to every rank, so that all of them
    fold the same commands at the same frame."""
    import torch.distributed as dist

    msg = [None, None, None]
    if interactor is not None:
        scene, changed = interactor.poll(scene, step_now)
        while interactor.paused:
            time.sleep(0.2)
            scene, ch2 = interactor.poll(scene, step_now)
            changed = changed or ch2
        msg = [scene, changed, interactor.take_events()]
    dist.broadcast_object_list(msg, src=0)
    return msg


def _run_spatial(args, scene, state, device) -> int:
    """`run --shards N` (slabs) or `--shards N1xN2` (pencils): the
    audited decomposed advance with elastic recovery (a re-spec from the
    gathered state when the flow outgrows the static buffers); a frame is
    one dispatch and one gather."""
    from sph_tpu_torch import decomp

    try:
        build, mesh_desc, n_total = _decomp_setup(args, scene, device)
    except _UsageError as e:
        _note(str(e))
        return 2
    pencil = len(args.shards) == 2
    lead = _lead()
    loc, adv = build(scene, state)
    watchdog = diagnostics.Watchdog(scene.params)
    interactor = (_Interactor(args.interact) if args.interact and lead
                  else None)
    metrics_path = os.path.join(args.out, "metrics.jsonl")
    t0 = time.perf_counter()
    mf = open(metrics_path, "a") if lead else None
    try:
        for frame in range(args.frames):
            if args.interact:
                scene, changed, events = _shared_commands(
                    interactor, scene, int(loc.step))
                if changed or events:
                    # one gather, every command folded in file order, one
                    # re-spec: build() sizes the caps from the final
                    # occupancy and spawned particles go to the rank that
                    # owns their position
                    st_g = decomp.spatial_gather_state(loc)
                    mutated = changed
                    for kind_, req in events:
                        if kind_ == "reset":
                            st_g = _fresh_state(scene, args.method, device)
                            mutated = True
                            _note("interact: scene reset")
                            continue
                        try:
                            st_g, k = spawn_particles(st_g, scene, **req)
                        except ValueError as e:
                            _note(f"interact: spawn ignored ({e})")
                            continue
                        mutated = mutated or k > 0
                        _note(f"interact: spawned {k} particles "
                              f"@ {req['pos']}")
                    if mutated:
                        loc, adv = build(scene, st_g)
            loc, adv = _advance_elastic(adv, loc, build, scene)
            view = decomp.spatial_gather_state(loc)
            pack = diagnostics.scalar_pack(view, scene.params)
            if args.render and lead:
                render.save_frame(
                    view, scene,
                    os.path.join(args.out, f"frame_{frame:05d}.png"),
                    width=args.width, height=args.height, mode=args.mode,
                    radius=args.radius,
                )
            try:
                # every rank checks the same gathered view, so all of them
                # stop at the same frame
                scalars = watchdog.check(pack)
            except diagnostics.SimulationDiverged as e:
                if lead:
                    dump = os.path.join(args.out, "diverged_state.npz")
                    diagnostics.save_checkpoint(dump, view, scene)
                    print(f"DIVERGED at frame {frame}: {e}; state -> {dump}",
                          file=sys.stderr)
                return 2
            if not lead:
                continue
            scalars["frame"] = frame
            scalars["step"] = int(loc.step)
            scalars["shards"] = n_total
            if pencil:
                scalars["mesh"] = mesh_desc
            scalars["wall_s"] = time.perf_counter() - t0
            if hasattr(adv, "mode"):
                scalars["advance_mode"] = adv.mode
            if hasattr(adv, "healed"):
                scalars["healed_blocks"] = adv.healed
                scalars["repaired_blocks"] = getattr(adv, "repaired", 0)
            mf.write(json.dumps(scalars) + "\n")
            mf.flush()
            if args.checkpoint_every and (frame + 1) % args.checkpoint_every == 0:
                diagnostics.save_checkpoint(
                    os.path.join(args.out, f"ckpt_{frame:05d}.npz"),
                    view, scene,
                )
            if not args.quiet:
                print(
                    f"frame {frame:4d} step {int(loc.step):7d} "
                    f"n={int(scalars['n_active'])} "
                    f"max|v|={scalars['max_speed']:8.2f} "
                    f"rho={scalars['mean_rho']:8.2f} "
                    f"shards={mesh_desc} "
                    f"({scalars['wall_s']:.1f}s)"
                )
    finally:
        if mf is not None:
            mf.close()
    return 0


def _record_spatial(args, scene, state, device) -> int:
    """`record --shards ...`: advance decomposed, gather each frame, and
    rank 0 renders the global view; the same audited advance and elastic
    recovery as run."""
    from sph_tpu_torch import decomp

    try:
        build, mesh_desc, _ = _decomp_setup(args, scene, device)
    except _UsageError as e:
        _note(str(e))
        return 2
    lead = _lead()
    loc, adv = build(scene, state)
    fields = []
    t0 = time.time()
    for frame in range(args.frames):
        loc, adv = _advance_elastic(adv, loc, build, scene)
        view = decomp.spatial_gather_state(loc)
        if not lead:
            continue
        fields.append(render.render_splat(
            view, scene, args.width, args.height, args.mode,
            radius=args.radius,
        ).cpu().numpy())
        if not args.quiet:
            print(f"frame {frame} shards={mesh_desc} "
                  f"({time.time()-t0:.1f}s)", flush=True)
    if lead:
        render.save_apng(args.out, fields, fps=args.fps)
        print(f"wrote {args.out} ({len(fields)} frames)")
    return 0


def cmd_run(args, device) -> int:
    scene = _load_scene(args.preset)
    if args.resume:
        state, scene = diagnostics.load_checkpoint(args.resume, device=device)
    else:
        state = _fresh_state(scene, args.method, device)
    os.makedirs(args.out, exist_ok=True)
    if args.shards:
        return _run_spatial(args, scene, state, device)
    spf = _spf(args)
    if args.debug:
        # sanitizer-style stepping: the checked step raises at the first
        # step whose checks fail
        if args.sort_every > 1 or args.resident:
            print(
                "note: --debug steps one-at-a-time; "
                "--sort-every/--resident are ignored",
                file=sys.stderr,
            )

        def _mk_adv(sc):
            checked = diagnostics.make_checked_step(sc, args.method, device)

            def adv_dbg(st):
                for _ in range(spf):
                    st = checked(st)
                return st

            return adv_dbg
    else:
        def _mk_adv(sc):
            return _audited(args, sc, spf, device)

    # interactor scene edits rebuild via the SAME factory, so the debug
    # checks / fast-path audit survive a mid-run rebuild
    adv = _mk_adv(scene)
    overflow_fn = None
    if args.method == "pallas":
        # per-frame static-cap audit on the grid geometry the stepping
        # uses (the skinned grid under --sort-every>1): the kernels drop
        # overflow by design, so surface it
        from sph_tpu_torch import neighbors, pallas_step
        from sph_tpu_torch.step import default_skin

        _base = neighbors.GridSpec.for_scene(scene)
        if args.sort_every > 1 and not args.debug:
            _grid = neighbors.GridSpec.for_scene(
                scene, cap=_base.cap,
                skin=default_skin(scene, args.sort_every),
            )
        else:
            _grid = _base
        _sg = pallas_step.slot_grid(_grid)

        def overflow_fn(s):
            return pallas_step.slot_overflow(s.x, s.active, _grid, _sg)
    watchdog = diagnostics.Watchdog(scene.params)
    interactor = _Interactor(args.interact) if args.interact else None
    metrics_path = os.path.join(args.out, "metrics.jsonl")
    t0 = time.perf_counter()
    with open(metrics_path, "a") as mf:
        for frame in range(args.frames):
            if interactor is not None:
                scene, changed = interactor.poll(scene, int(state.step))
                if changed:
                    adv = _mk_adv(scene)
                while interactor.paused:
                    time.sleep(0.2)
                    scene, changed = interactor.poll(scene, int(state.step))
                    if changed:
                        adv = _mk_adv(scene)
                for kind_, req in interactor.take_events():
                    if kind_ == "reset":
                        state = _fresh_state(scene, args.method, device)
                        # rebuild the advance too: the policies' state (a
                        # cap switch, a fitted skin) must not survive it
                        adv = _mk_adv(scene)
                        print("interact: scene reset", file=sys.stderr)
                        continue
                    try:
                        state, k = spawn_particles(state, scene, **req)
                    except ValueError as e:
                        print(f"interact: spawn ignored ({e})",
                              file=sys.stderr)
                        continue
                    print(f"interact: spawned {k} particles "
                          f"@ {req['pos']}", file=sys.stderr)
            state = adv(state)
            pack = diagnostics.scalar_pack(state, scene.params)
            if args.render:
                render.save_frame(
                    state, scene,
                    os.path.join(args.out, f"frame_{frame:05d}.png"),
                    width=args.width, height=args.height, mode=args.mode,
                    radius=args.radius,
                )
            try:
                scalars = watchdog.check(pack)
            except diagnostics.SimulationDiverged as e:
                dump = os.path.join(args.out, "diverged_state.npz")
                diagnostics.save_checkpoint(dump, state, scene)
                print(f"DIVERGED at frame {frame}: {e}; state -> {dump}",
                      file=sys.stderr)
                return 2
            scalars["frame"] = frame
            scalars["step"] = int(state.step)
            scalars["wall_s"] = time.perf_counter() - t0
            # which phase the policies are in (cap8/cap16, packed/slot,
            # resident/perstep) and the cumulative heal/repair counters
            if hasattr(adv, "mode"):
                scalars["advance_mode"] = adv.mode
            if hasattr(adv, "healed"):
                scalars["healed_blocks"] = adv.healed
                scalars["repaired_blocks"] = getattr(adv, "repaired", 0)
            if overflow_fn is not None:
                cell_over, row_over = overflow_fn(state)
                scalars["cap_dropped"] = int(cell_over)
                scalars["row_overflow"] = int(row_over)
                if scalars["cap_dropped"] or scalars["row_overflow"]:
                    print(
                        f"warning: static caps dropped work this frame "
                        f"(cells {scalars['cap_dropped']}, rows "
                        f"{scalars['row_overflow']}) — raise Scene.grid_cap "
                        f"or c_rows",
                        file=sys.stderr,
                    )
            cfl = diagnostics.cfl_limit(scene.params, scalars["max_speed"])
            if cfl is not None and scene.params.dt > cfl:
                scalars["cfl_warning"] = True
                print(
                    f"warning: dt={scene.params.dt:.2e} exceeds CFL {cfl:.2e}",
                    file=sys.stderr,
                )
            mf.write(json.dumps(scalars) + "\n")
            mf.flush()
            if args.checkpoint_every and (frame + 1) % args.checkpoint_every == 0:
                diagnostics.save_checkpoint(
                    os.path.join(args.out, f"ckpt_{frame:05d}.npz"),
                    state, scene,
                )
            if not args.quiet:
                print(
                    f"frame {frame:4d} step {int(state.step):7d} "
                    f"n={int(scalars['n_active'])} "
                    f"max|v|={scalars['max_speed']:8.2f} "
                    f"rho={scalars['mean_rho']:8.2f} "
                    f"({scalars['wall_s']:.1f}s)"
                )
    return 0


def cmd_record(args, device) -> int:
    """Frames rendered on the device → one animated PNG."""
    scene = _load_scene(args.preset)
    state = _fresh_state(scene, args.method, device)
    if args.shards:
        return _record_spatial(args, scene, state, device)
    adv = _audited(args, scene, _spf(args), device)
    fields = []
    t0 = time.time()
    for frame in range(args.frames):
        state = adv(state)
        fields.append(render.render_splat(
            state, scene, args.width, args.height, args.mode,
            radius=args.radius,
        ).cpu().numpy())
        if not args.quiet:
            print(f"frame {frame} ({time.time()-t0:.1f}s)", flush=True)
    render.save_apng(args.out, fields, fps=args.fps)
    print(f"wrote {args.out} ({len(fields)} frames)")
    return 0


def _device_arg(text: str) -> str:
    if re.fullmatch(r"cpu|cuda(:\d+)?", text):
        return text
    raise argparse.ArgumentTypeError(
        f"invalid device {text!r} (cuda, cuda:K or cpu)")


def _add_common(p, frames: int, spf: int, out: str) -> None:
    """The flags `run` and `record` share, with the reference's defaults."""
    p.add_argument("preset",
                   help=f"preset name {preset_names()} or a scene .json")
    p.add_argument("--method", default="auto",
                   choices=["auto", "naive", "grid", "pallas"],
                   help="auto (default) = the pallas production default "
                        "(sort-every 4 + resident w/ auto-rebuild); "
                        "naive/grid = oracle/portable paths")
    p.add_argument("--frames", type=int, default=frames)
    p.add_argument("--steps-per-frame", type=int, default=spf)
    p.add_argument("--out", default=out)
    p.add_argument("--mode", default="density",
                   choices=["density", "rho", "speed", "depth"])
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=300)
    p.add_argument("--radius", type=int, default=1,
                   help="splat radius in px (GL point-sprite analog)")
    p.add_argument("--sort-every", type=int, default=1,
                   help="pallas Verlet-skin addr reuse interval "
                        "(>1: rebuild neighbor addressing every K steps)")
    p.add_argument("--resident", action="store_true",
                   help="slot-resident block integration (fastest pallas "
                        "mode; requires --sort-every>1; emitter "
                        "activations freeze until the next rebuild)")
    p.add_argument("--adaptive-cap", action="store_true",
                   help="start on a cap-8 slot grid while occupancy "
                        "allows, healing overflow blocks exactly and "
                        "switching to the default cap when outgrown "
                        "(requires --resident)")
    p.add_argument("--repair-k", type=int, default=None,
                   help="minority slot repair budget (auto-rebuild "
                        "resident mode): re-home up to K risky particles "
                        "in place of a full addressing rebuild (default: "
                        "auto — 2048 where supported; 0 = off)")
    p.add_argument("--packed-rows", choices=("auto", "on", "off"),
                   default="auto",
                   help="packed-row sparse-scene kernels (resident fast "
                        "path): auto = probe the state and use them for "
                        "sparse emitter scenes, on/off = pin")
    p.add_argument("--strict-audit", action="store_true",
                   help="disable the membership-relaxed Verlet audit (A/B "
                        "knob: drift-only audits + velocity-projection "
                        "rebuild predicate)")
    p.add_argument("--shards", type=_parse_shards, default=None,
                   help="domain decomposition: N = spatial slabs, N1xN2 = "
                        "2-axis pencils (0 = single device); one process "
                        "a rank, under torchrun --nproc-per-node N")
    p.add_argument("--shard-axis", type=int, default=0,
                   help="domain axis the slabs cut / first pencil axis")
    p.add_argument("--shard-axis2", type=int, default=None,
                   help="second pencil cut axis (with --shards N1xN2; "
                        "default: the last domain axis)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda", type=_device_arg,
                   help="cuda (default; exits when there is no card; with "
                        "--shards each rank on cuda:LOCAL_RANK), cuda:K, or "
                        "cpu (the kernels' plain PyTorch versions)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sph-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a preset scene")
    _add_common(runp, frames=60, spf=100, out="out")
    runp.add_argument("--render", action="store_true")
    runp.add_argument("--interact", default=None, metavar="FILE",
                      help="poll FILE between frames for live interaction "
                           "commands (JSON lines: force_field / spawn / "
                           "reset / pause / resume)")
    runp.add_argument("--debug", action="store_true",
                      help="checked stepping: NaN positions, out-of-bounds "
                           "cells, tile-cap overflow and bad densities "
                           "raise — slower, one fetch a step")
    runp.add_argument("--checkpoint-every", type=int, default=0)
    runp.add_argument("--resume", default=None)
    runp.set_defaults(fn=cmd_run)

    recp = sub.add_parser("record", help="record an animated PNG")
    _add_common(recp, frames=100, spf=50, out="out.apng")
    recp.add_argument("--fps", type=float, default=20.0)
    recp.set_defaults(fn=cmd_record)

    listp = sub.add_parser("presets", help="list presets")
    listp.set_defaults(fn=None)

    args = ap.parse_args(argv)
    if args.cmd == "presets":
        print("\n".join(preset_names()))
        return 0
    # resolve + validate flag combos BEFORE the device probe, so a usage
    # error never touches the device
    _resolve_method(args)
    try:
        _validate_fastpath_flags(args)
    except _UsageError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.shards:
        return _decomposed(args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    return args.fn(args, device)


if __name__ == "__main__":
    sys.exit(main())
