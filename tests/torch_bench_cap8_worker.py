"""The benchmark's cap-8 configuration (`splash3d_1m-cap8`) at the small
size of `benchmark/tests/small.py`, run once by `benchmark.harness.run_cell`
on the CPU with its traced pass, for `test_torch_bench_cap8.py`.

    python tests/torch_bench_cap8_worker.py calm|switch

A process of its own: the harness refuses to report from a process that
has loaded JAX, as the tests' conftest does.  It imports only torch, the
benchmark and `sph_tpu_torch`.  Prints one JSON line: the run's `correct`,
`checks` and per-layer `metrics`; for each pass (the warm-up, the window's
one and the traced one, all from the same seeded state) the audited
advance's counters, the resident blocks it ran and a digest of each field
of its end state; and the spans of the traced pass.

`calm` holds the cap-8 lattice through 2 frames of 8 steps; in `switch`
the column is thrown at the floor at 450 px/s, so that the dispatch from
step 16 outgrows cap 8 and the last of 4 frames runs on cap 16.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time

import torch

from benchmark import harness, spec
from benchmark.tests.small import small_cell
from sph_tpu_torch import step

SEED = 2**31 + 77
CASES = {"calm": dict(steps=16, draw=((1, 1),), velocity=None),
         "switch": dict(steps=32, draw=((3, 3),), velocity=[0.0, -450.0, 0.0])}
FIELDS = ("x", "v", "acc", "rho", "p", "active", "step")


class Spy:
    """An audited advance as the harness made it, which keeps the state of
    its last call and the resident blocks run so far in the pass."""

    def __init__(self, adv):
        self.adv, self.end, self.blocks = adv, None, 0

    def __call__(self, st):
        self.end = self.adv(st)
        self.blocks = step.FETCHES["blocks"]
        return self.end

    def __getattr__(self, name):
        return getattr(self.adv, name)


def each(tr, name: str) -> list:
    """(start, end) of every span named `name` in the trace, in order."""
    return sorted((a, b) for n, a, b in tr.cpu if n == name)


def digest(st) -> dict:
    """sha256 of each field's bytes: equal digests are equal bits."""
    return {f: hashlib.sha256(getattr(st, f).contiguous().numpy()
                              .tobytes()).hexdigest() for f in FIELDS}


def main(case: str) -> None:
    torch.set_num_threads(1)
    c = CASES[case]
    cell = small_cell("splash3d_1m-cap8", steps=c["steps"], spf=8,
                      draw=c["draw"])
    cell.config["scene"]["blocks"][0]["velocity"] = c["velocity"]
    cell.per_layer = spec.load_cell("splash3d_1m-cap8.early").per_layer

    made, traces = [], []
    make, profiled = step.make_audited_advance, harness.trace_mod.profiled

    def spied(*a, **k):
        made.append(Spy(make(*a, **k)))
        return made[-1]

    def keep(fn, cuda):
        out, tr = profiled(fn, cuda)
        traces.append(tr)
        return out, tr

    step.make_audited_advance, harness.trace_mod.profiled = spied, keep
    r = harness.run_cell(cell, SEED, 0.0, True, torch.device("cpu"),
                         time.perf_counter())
    (tr,) = traces
    out = {
        "correct": r["correct"], "checks": r["checks"],
        "metrics": {k: v["value"] for k, v in r["metrics"].items()},
        "passes": [{"mode": a.mode, "healed": a.healed,
                    "rebuilds": a.rebuilds, "repaired": a.repaired,
                    "cap8_blocks": a.cap8_blocks,
                    "switch_step": a.switch_step, "blocks": a.blocks,
                    "digest": digest(a.end)} for a in made],
        "spans": {n: len(each(tr, n)) for n in
                  ("sph.cap8", "sph.cap_probe", "sph.block", "sph.heal")},
        "cap8_spans_in_frames": [
            int(sum(a <= t < b for t, _ in each(tr, "sph.cap8")))
            for _, a, b in sorted(s for s in tr.cpu
                                  if s[0] == "bench.advance")],
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
