"""The readings the limits of `correct` are set from, at a cell's own size.

    python -m benchmark.readings --workload <cell> --seeds 1 2 3 \
        [--precision bf16] [--frames run|all]

For each seed, in one process: one pass of the cell as a run makes it, then
the reference's gaps on the frames a run with that seed checks (`run`) or
on every frame (`all`).  `--precision bf16` runs the program's own bf16
feature path in place of the configured fp32: the control, which has to
come out not correct.  Each seed prints one JSON line: the gaps of each
frame, their largest, and `diag_gap_bf16`, the gap of the frame
diagnostics worked out by the reference in bfloat16 (the diagnostics'
control).  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import check, harness, spec
from benchmark.reference.sph import Reference, frame_scalars


def diag_gap_bf16(end: dict, pack: dict, mass: float) -> float:
    """The diagnostics' control: the scalars reduced in bfloat16 from the
    program's state, against float64."""
    want = frame_scalars(end, mass)
    act = end["emit_step"] <= end["step"]
    v = end["v"][act].bfloat16()
    rho = end["rho"][act].bfloat16()
    s2 = (v * v).sum(1)
    low = {"max_speed": float(torch.sqrt(s2.max())), "min_rho": float(rho.min()),
           "mean_rho": float(rho.sum() / act.sum()), "max_rho": float(rho.max()),
           "kinetic_energy": float(0.5 * mass * s2.sum())}
    return max(abs(low[n] - want[n]) / abs(want[n]) for n in check.DIAG)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--frames", choices=("run", "all"), default="run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.readings: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        prog = harness.Program(cell, seed, dev, precision=args.precision)
        ks = (list(range(prog.frames)) if args.frames == "all"
              else harness.checked_frames(cell.workload, seed))
        keep, checks = prog.new_keep(ks)
        t = time.perf_counter()
        frame_s, packs, counters = prog.run_pass(keep)
        pass_s = time.perf_counter() - t
        kept = prog.frames_to_check(checks, packs)
        scene, spf = prog.scene_dict, prog.spf
        expected = [prog.expected_active((k + 1) * spf)
                    for k in range(prog.frames)]
        scene = dict(scene, params=dict(scene["params"], precision="fp32"))
        del prog
        torch.cuda.empty_cache()
        ref = Reference(scene, dev)
        frames, t = {}, time.perf_counter()
        for k, start, end, pack in kept:
            g = check.frame_gaps(ref, scene, k, start, end, pack, spf)
            g["diag_gap_bf16"] = diag_gap_bf16(end, pack, scene["params"]["mass"])
            frames[str(k)] = g
        ref_s = time.perf_counter() - t
        worst = {n: max(f[n] for f in frames.values())
                 for n in next(iter(frames.values()))}
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "precision": args.precision or "fp32", "pass_s": pass_s,
            "frame_s": frame_s, "counters": counters, "ref_s": ref_s,
            "worst": worst, "frames": frames,
            "guarantees": check.guarantees(packs, expected, scene,
                                           cell.config["guarantees"])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
