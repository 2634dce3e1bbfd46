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
The decomposed run (`--shards`) exits 2: the library's `run(shards=N)`
runs per-step slabs under `torchrun`, and the command line's default
`--method auto` is the slab fast path, not ported yet; the
reference's `bench` subcommand drives a JAX benchmark folder and has no
counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
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
    if args.shards:
        raise _UsageError(
            "--shards: the command line's decomposed run is not ported yet "
            "(ROADMAP.md Queue 1 item 14.5); the library runs slabs, the "
            "fast path included, with run(shards=N) under torchrun")
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


def cmd_run(args, device) -> int:
    scene = _load_scene(args.preset)
    if args.resume:
        state, scene = diagnostics.load_checkpoint(args.resume, device=device)
    else:
        state = _fresh_state(scene, args.method, device)
    os.makedirs(args.out, exist_ok=True)
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
                        "2-axis pencils (0 = single device); not ported "
                        "yet")
    p.add_argument("--shard-axis", type=int, default=0,
                   help="domain axis the slabs cut / first pencil axis")
    p.add_argument("--shard-axis2", type=int, default=None,
                   help="second pencil cut axis (with --shards N1xN2)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default; exits when there is no card) or "
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
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 1
    return args.fn(args, device)


if __name__ == "__main__":
    sys.exit(main())
