"""The one-line benchmark of the port (port of the root `bench.py`).

    python -m sph_tpu_torch.bench                        # the ladder, on the card
    python -m sph_tpu_torch.bench --steps 8              # shorter dispatches
    python -m sph_tpu_torch.bench --config dam2d_10k     # one config
    python -m sph_tpu_torch.bench --config dam3d_100k --method resident4auto
    python -m sph_tpu_torch.bench --all                  # a JSON line a row
    python -m sph_tpu_torch.bench --device cpu --config tutorial2d

Metric: particle-steps/s (BASELINE.json's unit).  `vs_baseline` is a row's
rate over the rate of naive all-pairs at the same particle count on the
same card: `NAIVE_PAIR_RATE / n`.

Output protocol, the reference's: the flagship row (`splash3d_1m`,
`resident4auto`, the production default) runs first and its compact JSON
line (metric, value, unit, vs_baseline, ms_per_step and the policy's
counters, with `"partial": true`) is printed and flushed at once, so a run
cut short still leaves a line to parse.  The other rows run small to large
under a wall-clock budget (`--budget`, or `SPH_BENCH_BUDGET_S`, default
1500 s): a row that starts past it is recorded in `skipped`.  At the end
the whole ladder (`flagship`, `ladder`, `skipped`) is written to
`bench_ladder_torch.json` at the root of the checkout (full-ladder runs
only) and printed as a line, and the compact flagship line is printed
last.  Every row's slot overflow, on the lattice it ran, must be 0: a row
that dropped pairs names itself on stderr as `# OVERFLOW: ...` and the
command exits 1.  `--config` runs one config (with `--method`, one row;
without, the first of pallas, grid, naive that runs); `--all` prints one
JSON line a row instead of the ladder document and the compact line.

A row is recorded in `skipped` and the run goes on only for the
reference's designed refusals: a missing `@settled` checkpoint
(`FileNotFoundError`; `python -m sph_tpu_torch.make_settled_state` makes
both), a classic resident, reuse or slab row's skin violation
(`SkinViolation`), and an exhausted budget.  Any other exception (a kernel that does not
build or launch, a CUDA error, unhealed violations) ends the command with
its traceback and exit 1, after the lines already printed.  The device is
`--device` (default `cuda`): with no card the command exits 1 with one
line, and `--device cpu` runs the kernels' plain versions.

Timing is `bench_step.timed_chain`'s: after a warm dispatch, a pilot
dispatch sizes a chain of at most 64 dispatches holding about
`bench_step.CHAIN_TARGET_S` of work, and the best of three windows, each
ended by one checksum fetch, divided by its chain, is a dispatch's time.
The counters of the auto-rebuild rows stay on the device until the
timing is over; `healed_blocks` and `repairs` sum every dispatch's,
warm-up included, and `rebuilds_last_dispatch` is the last dispatch's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

from sph_tpu_torch import pallas_step
from sph_tpu_torch.bench_step import (
    _fresh,
    _pallas_steps,
    bench_audited,
    bench_pencil,
    bench_spatial,
    checksum,
    timed_chain,
)
from sph_tpu_torch.diagnostics import load_checkpoint
from sph_tpu_torch.make_settled_state import settled_path
from sph_tpu_torch.neighbors import GridSpec
from sph_tpu_torch.params import _dam_break_2d, preset
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

#: Naive all-pairs pairs a second on the card, the baseline of
#: `vs_baseline` (the reference's is a TPU figure and is not kept): the
#: median of three calls of `naive_pair_rate("cuda")` on an NVIDIA H100
#: 80GB HBM3 at 700.00 W (`nvidia-smi --query-gpu=name,power.limit
#: --format=csv,noheader`), 10.34 ms a step at 8,192 particles, the three
#: within 0.03% of each other.  `chip_smoke.py`'s ladder phase measures it
#: again beside this value.
NAIVE_PAIR_RATE = 6.489697670860887e9

#: The full ladder's record, beside the reference's `bench_ladder.json`,
#: which this module never writes.
LADDER_FILE = Path(__file__).resolve().parent.parent / "bench_ladder_torch.json"

#: Scene → its place in the small-to-large order of the rows after the
#: flagship.
SIZE_RANK = {"tutorial2d": 0, "dam2d_10k": 1, "emitters3d": 2,
             "vortex2d": 3, "dam3d_100k": 4, "splash3d_1m": 5}


class SkinViolation(RuntimeError):
    """A classic resident, reuse or slab row's skin violation: its physics
    was degraded, so the row refuses a number (the reference raises a
    RuntimeError and records the row as skipped)."""


#: The exceptions a row may end with and leave the run going: the
#: reference's designed refusals.
REFUSALS = (FileNotFoundError, SkinViolation)


def _error_text(e: BaseException) -> str:
    """An exception as the reference records it (a skin violation is its
    RuntimeError)."""
    kind = RuntimeError if isinstance(e, SkinViolation) else type(e)
    return f"{kind.__name__}: {e}"


def naive_pair_rate(device=None, n: int = 8192, steps: int = 100) -> dict:
    """Naive all-pairs on the card, BASELINE.md's protocol: the port's
    `method="naive"` step on a 2D dam break of ~`n` particles, fp32,
    `steps` steps a dispatch, chained windows.  Returns the active count,
    particle-steps/s, ms a step and the pair rate (particle-steps/s × n)."""
    device = resolve_device(device)
    scene = _dam_break_2d(n)
    state = _fresh(scene, "naive", device)
    adv = make_advance(scene, "naive", steps_per_dispatch=steps,
                       device=device)
    state = adv(state)
    checksum(state)
    best, state, _ = timed_chain(lambda st: (adv(st), None), state)
    n_act = int(state.n_active())
    rate = n_act * steps / best
    return {"n": n_act, "particle_steps_per_s": rate,
            "ms_per_step": best / steps * 1e3, "pair_rate": rate * n_act}


def _vs_baseline(pstep_s: float, n: int) -> float:
    return pstep_s / (NAIVE_PAIR_RATE / n)


def _result(name: str, method: str, n: int, pstep_s: float,
            s_per_step: float, overflow: int) -> dict:
    return {
        "config": name,
        "method": method,
        "n": n,
        "particle_steps_per_s": pstep_s,
        "ms_per_step": s_per_step * 1e3,
        "slot_overflow": overflow,
        # over naive all-pairs at the same n on the same card
        "vs_baseline": _vs_baseline(pstep_s, n),
    }


def overflow_counts(scene, state, method: str, sort_every: int = 1,
                    xsub: int = 1) -> int:
    """Static-cap overflow at `state` on the lattice the row ran (the
    skinned one for sort_every > 1, whose cells hold more particles); 0
    for methods other than pallas.  Nonzero: the row dropped pair physics
    and its number is invalid."""
    if method != "pallas":
        return 0
    base = GridSpec.for_scene(scene)
    if sort_every > 1:
        grid = GridSpec.for_scene(scene, cap=base.cap,
                                  skin=default_skin(scene, sort_every),
                                  xsub=xsub)
    else:
        grid = GridSpec.for_scene(scene, xsub=xsub)
    sg = pallas_step.slot_grid(grid)
    cell_over, row_over = pallas_step.slot_overflow(state.x, state.active,
                                                    grid, sg)
    return int(cell_over) + int(row_over)


def bench_config(scene, method: str, steps: int, repeats: int = 3,
                 sort_every: int = 1, slot_resident: bool = False,
                 xsub: int = 1, auto_rebuild: bool = False,
                 counters: dict | None = None, state0=None, device=None):
    """(particle-steps/s, s/step, n, slot overflow) of `method` on `scene`
    from its init, or from `state0`.  With `auto_rebuild` the policy's
    repair_k and packed rows resolve as `make_audited_advance` resolves
    them, and `counters` gathers `packed`, `healed`, `rebuilds` and
    `repairs`."""
    device = resolve_device(device)
    if method == "pallas":
        # the reference bench's dispatch (ROADMAP Queue 3 item 4)
        steps = _pallas_steps(steps, sort_every)
    state = init(scene, device=device) if state0 is None else state0
    if scene.params.integrator == "leapfrog" and int(state.step) == 0:
        state = prime(scene, state, method=method, device=device)
    repair_k = 0
    packed = False
    if auto_rebuild:
        packed = (bool(scene.emitters) and xsub == 1
                  and scene.params.precision != "bf16"
                  and packed_fits(scene, state, sort_every))
        repair_k = default_repair_k(scene, auto=True, xsub=xsub,
                                    packed_rows=packed)
        if counters is not None:
            counters["packed"] = packed
    adv = make_advance(scene, method, steps_per_dispatch=steps,
                       sort_every=sort_every, slot_resident=slot_resident,
                       xsub=xsub, auto_rebuild=auto_rebuild,
                       repair_k=repair_k, packed_rows=packed, device=device)

    def one(st):
        """One dispatch → (state, its audit): the counts stay on the
        device until the audit runs, after the timing."""
        if auto_rebuild:
            out = adv(st)

            # only the counts: a chain holds many audits at once, and the
            # whole `out` would keep every state of the chain alive
            def audit(tail=out[1:]):
                viol, healed, rebuilds = (int(c) for c in tail[:3])
                if counters is not None:
                    counters["healed"] = counters.get("healed", 0) + healed
                    counters["rebuilds"] = rebuilds
                    if len(tail) > 3:
                        counters["repairs"] = (counters.get("repairs", 0)
                                               + int(tail[3]))
                if viol:
                    raise RuntimeError(f"{viol} unhealed violations")

            return out[0], audit
        if sort_every > 1:
            st, viol = adv(st)

            def audit(viol=viol):
                if int(viol):
                    raise SkinViolation(f"sort_every={sort_every}: "
                                        f"{int(viol)} skin violations")

            return st, audit
        return adv(st), lambda: None

    state, audit0 = one(state)
    checksum(state)
    audit0()
    best, state, audits = timed_chain(one, state, repeats)
    for audit in audits:
        audit()
    n_active = int(state.n_active())
    overflow = overflow_counts(scene, state, method, sort_every, xsub)
    return n_active * steps / best, best / steps, n_active, overflow


def bench_auto(name: str, steps: int, sort_every: int = 4,
               device=None) -> dict:
    """The cap-8 policy's row (`make_audited_advance(adaptive_cap=True)`):
    the cap-8 lattice while the flow fits, overflow blocks healed exactly,
    the default cap once outgrown; `healed_blocks` and `cap_mode` show a
    phase change inside the timed windows.  The policy's own fetch a
    dispatch stays inside the windows."""
    device = resolve_device(device)
    scene = preset(name)
    steps = _pallas_steps(steps, sort_every)
    state = _fresh(scene, "pallas", device)
    adv = make_audited_advance(scene, "pallas", steps, sort_every=sort_every,
                               slot_resident=True, adaptive_cap=True,
                               device=device)
    state = adv(state)
    checksum(state)
    best, state, _ = timed_chain(lambda st: (adv(st), None), state)
    n = int(state.n_active())
    pstep_s = n * steps / best
    return {
        "config": name,
        "method": f"resident{sort_every}+auto8",
        "n": n,
        "particle_steps_per_s": pstep_s,
        "ms_per_step": best / steps * 1e3,
        "slot_overflow": 0,     # a heal re-runs any overflow block exactly
        "healed_blocks": adv.healed,
        "cap_mode": adv.mode,
        "vs_baseline": _vs_baseline(pstep_s, n),
    }


def measure(name: str, method: str, steps: int, sort_every: int = 1,
            slot_resident: bool = False, xsub: int = 1,
            device=None) -> dict:
    """One ladder row → its result; raises if the row cannot run."""
    device = resolve_device(device)
    if method.endswith("+auto8"):
        return bench_auto(name, steps,
                          int(method[len("resident"):-len("+auto8")]),
                          device=device)
    if method == "pencil" or method.startswith("audited"):
        # the 1x1 pencil (the two-hop ghost machinery on one device), and
        # the audited policy with its heals and demotion timed
        if method == "pencil":
            pstep_s, s_per_step, n = bench_pencil(name, steps, device=device)
            label = "pencil1x1"
        else:
            pstep_s, s_per_step, n = bench_audited(
                name, steps, sort_every=int(method[len("audited"):]),
                device=device)
            label = method
        # the audited advances heal or raise on overflow
        return _result(name, label, n, pstep_s, s_per_step, 0)
    if method.startswith("spatial-resident"):
        # the slab fast path on a one-rank group
        tail = method[len("spatial-resident"):]
        auto_sp = tail.endswith("auto")
        try:
            pstep_s, s_per_step, n = bench_spatial(
                name, int(tail[:-4] if auto_sp else tail), steps,
                auto=auto_sp, device=device)
        except RuntimeError as e:
            # the classic slab row refuses a number on a skin violation,
            # as the classic resident rows do; the auto form's count is
            # what its heals left (bench_step._check_clean's text)
            if auto_sp or not str(e).endswith("spatial cap/skin violations"):
                raise
            raise SkinViolation(str(e)) from e
        # bench_spatial raises on any audit hit
        return _result(name, method, n, pstep_s, s_per_step, 0)
    state0 = None
    if name.endswith("@settled"):
        base = name[: -len("@settled")]
        ckpt = settled_path(base)
        if ckpt is None or not os.path.exists(ckpt):
            raise FileNotFoundError(
                f"no settled checkpoint for {base} — run python -m "
                f"sph_tpu_torch.make_settled_state")
        state0, scene = load_checkpoint(ckpt, device=device)
    else:
        scene = preset(name)
    auto = method.endswith("auto")
    if auto and method.startswith("resident"):
        # "residentKauto" names the whole configuration
        sort_every = int(method[len("resident"):-len("auto")])
        slot_resident = True
    counters: dict = {}
    pstep_s, s_per_step, n, overflow = bench_config(
        scene, method if not auto else "pallas", steps,
        sort_every=sort_every, slot_resident=slot_resident, xsub=xsub,
        auto_rebuild=auto, counters=counters, state0=state0, device=device)
    label = method
    if counters.get("packed"):
        label += "+packed"
    if sort_every > 1 and not auto:
        label += (f"+resident{sort_every}" if slot_resident
                  else f"+reuse{sort_every}")
    res = _result(name, label, n, pstep_s, s_per_step, overflow)
    if auto:
        res["healed_blocks"] = counters.get("healed", 0)
        res["rebuilds_last_dispatch"] = counters.get("rebuilds", 0)
        if "repairs" in counters:
            res["repairs"] = counters["repairs"]
        res["slot_overflow"] = 0    # a heal re-ran any overflow block exactly
    return res


def _compact(flag: dict, n_entries: int, n_skipped: int) -> dict:
    """The short JSON object of one flagship result, the last line."""
    out = {
        "metric": (f"particle-steps/sec ({flag['config']}, "
                   f"{flag['method']}, n={flag['n']})"),
        "value": flag["particle_steps_per_s"],
        "unit": "particle-steps/s",
        "vs_baseline": flag["vs_baseline"],
        "ms_per_step": flag["ms_per_step"],
        "ladder_entries": n_entries,
        "ladder_skipped": n_skipped,
        "ladder_file": LADDER_FILE.name,
    }
    for k in ("healed_blocks", "rebuilds_last_dispatch", "repairs"):
        if k in flag:
            out[k] = flag[k]
    return out


def ladder_rows(steps: int) -> list:
    """(config, method, steps, sort_every, slot_resident) of the ladder,
    the flagship first (`bench.py:515-558`)."""
    return [
        ("splash3d_1m", "resident4auto", steps, 4, True),
        ("splash3d_1m@settled", "resident4auto", steps, 4, True),
        ("splash3d_1m", "resident4+auto8", steps, 4, True),
        ("splash3d_1m", "pallas", steps, 4, True),
        ("splash3d_1m", "pallas", steps, 1, False),
        ("splash3d_1m", "spatial-resident4auto", steps, 4, True),
        ("splash3d_1m", "spatial-resident4", steps, 4, True),
        ("dam3d_100k", "resident4auto", steps, 4, True),
        ("dam3d_100k", "pallas", steps, 4, True),
        ("dam3d_100k", "pallas", steps, 1, False),
        # the grid method is slow at 100k: a short row keeps its record
        ("dam3d_100k", "grid", min(steps, 10), 1, False),
        ("dam3d_100k", "pencil", steps, 1, False),
        ("dam2d_10k", "resident4auto", steps, 4, True),
        ("dam2d_10k", "pallas", steps, 4, True),
        ("dam2d_10k", "resident4+auto8", steps, 4, True),
        ("dam2d_10k", "pallas", steps, 1, False),
        ("dam2d_10k", "grid", steps, 1, False),
        ("emitters3d@settled", "resident4auto", steps, 4, True),
        ("vortex2d", "audited4", steps, 4, True),
        # long dispatches: naive has no dispatch clamp
        ("tutorial2d", "naive", max(steps, 2000), 1, False),
    ]


class _RowFailed(Exception):
    """A row ended with an exception that is no designed refusal."""


def _try(row: tuple, xsub: int, device):
    """(result, None), or (None, error text) for a designed refusal; any
    other exception is printed with its traceback and raises _RowFailed."""
    name, method, steps, k, res = row
    try:
        return measure(name, method, steps, sort_every=k, slot_resident=res,
                       xsub=xsub if method == "pallas" else 1,
                       device=device), None
    except REFUSALS as e:
        err = _error_text(e)
        print(f"# {name}/{method} unavailable: {err}", file=sys.stderr,
              flush=True)
        return None, err
    except Exception as e:
        traceback.print_exc()
        print(f"# {name}/{method} failed: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        raise _RowFailed from e


def _run_config(ladder: list, xsub: int, device) -> tuple:
    """The first row of `ladder` that runs; the refusals before it
    skipped."""
    results, skipped = [], []
    for row in ladder:
        res, err = _try(row, xsub, device)
        if res is not None:
            results.append(res)
            break
        skipped.append({"config": row[0], "method": row[1],
                        "error": err[:300]})
    return results, skipped


def _run_ladder(ladder: list, xsub: int, budget: float, device) -> tuple:
    """The flagship, its compact line printed at once, then the other rows
    small to large while the budget lasts."""
    by_index: dict = {}
    skipped, refused = [], []
    t_start = time.perf_counter()
    early_line_printed = False

    def try_row(i: int) -> str | None:
        name, method = ladder[i][:2]
        print(f"# [{time.perf_counter() - t_start:7.1f}s] row "
              f"{name}/{method} starting", file=sys.stderr, flush=True)
        res, err = _try(ladder[i], xsub, device)
        if res is not None:
            by_index[i] = res
        return err

    def emit_early(i: int) -> None:
        nonlocal early_line_printed
        line = _compact(by_index[i], len(by_index), len(skipped))
        line["partial"] = True
        print(json.dumps(line), flush=True)
        early_line_printed = True

    flag_err = try_row(0)
    if flag_err is None:
        emit_early(0)
    else:
        skipped.append({"config": ladder[0][0], "method": ladder[0][1],
                        "error": flag_err[:300]})
    order = sorted(range(1, len(ladder)),
                   key=lambda i: SIZE_RANK.get(ladder[i][0].split("@")[0], 9))
    for i in order:
        elapsed = time.perf_counter() - t_start
        name, method = ladder[i][:2]
        if elapsed > budget:
            skipped.append({
                "config": name, "method": method,
                "error": (f"time budget exhausted "
                          f"({elapsed:.0f}s > {budget:.0f}s)")})
            print(f"# {name}/{method} skipped: budget exhausted "
                  f"({elapsed:.0f}s)", file=sys.stderr, flush=True)
            continue
        err = try_row(i)
        if err is not None:
            refused.append((i, err))
        elif not early_line_printed:
            # the flagship refused: the first row that ran takes its place
            emit_early(i)
    skipped += [{"config": ladder[i][0], "method": ladder[i][1],
                 "error": err[:300]} for i, err in refused]
    return [by_index[i] for i in sorted(by_index)], skipped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sph_tpu_torch.bench")
    ap.add_argument("--config", default="auto")
    ap.add_argument("--method", default="auto")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--sort-every", type=int, default=1,
                    help="pallas Verlet-skin addr reuse interval")
    ap.add_argument("--slot-resident", action="store_true",
                    help="integrate in slot space (requires --sort-every>1)")
    ap.add_argument("--xsub", type=int, default=1,
                    help="pallas x-cell subdivision (see GridSpec.xsub)")
    ap.add_argument("--all", action="store_true",
                    help="print one JSON line per ladder entry (default: "
                         "the ladder as a line, then the flagship's)")
    ap.add_argument("--budget", type=float,
                    default=float(os.environ.get("SPH_BENCH_BUDGET_S",
                                                 "1500")),
                    help="wall-clock seconds for the full ladder: the "
                         "flagship always runs, a later row that would "
                         "start past it is skipped (default 1500, env "
                         "SPH_BENCH_BUDGET_S)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = entry_device(args.device)
    if device is None:
        return 1

    ladder = ladder_rows(args.steps)
    try:
        if args.config != "auto":
            k = args.sort_every
            res = args.slot_resident and k > 1
            if args.method != "auto":
                ladder = [(args.config, args.method, args.steps, k, res)]
            else:
                # fastest first (naive at 100k+ would need an [N, N] pair
                # matrix)
                ladder = [(args.config, m, args.steps,
                           k if m == "pallas" else 1,
                           res if m == "pallas" else False)
                          for m in ("pallas", "grid", "naive")]
            results, skipped = _run_config(ladder, args.xsub, device)
        else:
            results, skipped = _run_ladder(ladder, args.xsub, args.budget,
                                           device)
    except _RowFailed:
        return 1

    if not results:
        print(json.dumps({"metric": "no-config-ran", "value": 0.0,
                          "unit": "particle-steps/s", "vs_baseline": 0.0}))
        return 1

    bad = [r for r in results if r["slot_overflow"]]
    for r in bad:
        print(f"# OVERFLOW: {r['config']}/{r['method']} dropped "
              f"{r['slot_overflow']} slots — measurement invalid",
              file=sys.stderr)

    if args.all:
        for r in results:
            print(json.dumps({
                "metric": (f"particle-steps/sec ({r['config']}, "
                           f"{r['method']}, n={r['n']})"),
                "value": r["particle_steps_per_s"],
                "unit": "particle-steps/s",
                "vs_baseline": r["vs_baseline"],
                "slot_overflow": r["slot_overflow"],
            }))
    else:
        flag = results[0]
        # the ladder on a line of its own: the last line stays short
        ladder_doc = {"flagship": flag["config"], "ladder": results,
                      "skipped": skipped}
        if args.config == "auto":
            LADDER_FILE.write_text(json.dumps(ladder_doc, indent=1))
        print(json.dumps(ladder_doc), flush=True)
        print(json.dumps(_compact(flag, len(results), len(skipped))),
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
