"""One run of one cell: set-up, the measured window of whole passes, the
traced pass, the reference's check, and the result line.

A pass is the user's job: simulate the cell's arc of steps from the seeded
state, as the program's command line runs it: prime, then one call of the
audited advance a frame (`steps_per_frame` steps), each frame ending in the
fetch of its diagnostics.  Passes run back to back until `--seconds` have
elapsed; the pass under way then is completed, so the window holds whole
passes of identical work, and the steps it reaches do not depend on the
card's speed.
"""

from __future__ import annotations

import json
import os
import random
import resource
import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.autograd.profiler import record_function

from benchmark import check, spec
from benchmark import trace as trace_mod
from benchmark.reference.seed_state import FIELDS, seed_arrays
from benchmark.reference.sph import pairs_within

FORBIDDEN = {"jax", "jaxlib", "flax", "sph_tpu"}
KEPT = ("x", "v", "acc", "rho", "p", "step")    # what a kept frame holds


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _cuda(device):
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    """Peak device memory allocated since the last reset (0 on the CPU,
    where the tests drive the harness)."""
    return torch.cuda.max_memory_allocated(device) if _cuda(device) else 0


def _cuda_mallocs(device) -> int:
    """cudaMalloc calls the caching allocator has made so far."""
    if not _cuda(device):
        return 0
    return torch.cuda.memory_stats(device).get("segment.all.allocated", 0)


def _host() -> tuple[float, int, float]:
    """(this thread's CPU seconds, its involuntary context switches, the
    seconds the hypervisor stole from this machine's CPUs, summed over
    them): read around each pass of the window, to tell a slower host
    from a busier one."""
    ru = resource.getrusage(resource.RUSAGE_THREAD)
    with open("/proc/stat") as fh:
        steal = int(fh.readline().split()[8])
    return time.thread_time(), ru.ru_nivcsw, steal / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def checked_frames(workload: dict, seed: int) -> list:
    """Frame 0, from the seeded state, and one frame drawn from the seed out
    of each of the workload's `check.draw` ranges (inclusive), in that
    order; every seed checks as many frames."""
    rng = random.Random(seed)
    return [0, *(rng.randint(a, b) for a, b in workload["check"]["draw"])]


class Program:
    """The port, set up for one cell and seed as its command line would run
    it, with the seeded state made by the benchmark."""

    def __init__(self, cell: spec.Cell, seed: int, device, precision=None):
        from sph_tpu_torch import diagnostics, params, state, step

        self.diagnostics, self.step = diagnostics, step
        scene = dict(cell.config["scene"], seed=seed)
        if precision is not None:
            scene["params"] = dict(scene["params"], precision=precision)
        self.scene_dict = scene
        self.scene = params.scene_from_json(json.dumps(scene))
        self.path = cell.config["path"]
        self.spf = cell.workload["steps_per_frame"]
        self.frames = cell.workload["steps"] // self.spf
        self.device = device
        arrays = seed_arrays(scene, seed)
        self.emit = arrays["emit_step"]
        self.pristine = state.State(**{
            f: torch.from_numpy(arrays[f]).to(device) for f in FIELDS})

    def expected_active(self, step: int) -> int:
        return int((self.emit <= step).sum())

    def particle_steps(self) -> int:
        """Active particles × steps of one pass, from the seeded schedule."""
        s = self.frames * self.spf
        e = self.emit.astype(np.int64)
        return int(np.maximum(s - np.maximum(e[e < s], 0), 0).sum())

    def new_keep(self, ks: list) -> tuple[dict, list]:
        """Buffers for the checked frames `ks`, made before the window: the
        end state of each, and for k > 0 the state it starts from, the end
        of frame k - 1.  As many buffers for every seed, so that the seed
        does not change the memory.  Returns ({frame: the buffers its end
        state is copied to}, [(k, start buffer or None, end buffer)])."""
        def buf():
            return {f: torch.empty_like(getattr(self.pristine, f)) for f in KEPT}
        into: dict = {}
        checks = []
        for k in ks:
            start = None if k == 0 else buf()
            end = buf()
            if start is not None:
                into.setdefault(k - 1, []).append(start)
            into.setdefault(k, []).append(end)
            checks.append((k, start, end))
        return into, checks

    def run_pass(self, keep: dict | None = None, starts: list | None = None):
        """One pass: (seconds of each frame, fetched diagnostics of each
        frame, the program's counters).  `keep` ({frame: buffers}) receives
        the end states of its frames; `starts` the positions and active
        masks each frame starts from."""
        step, diag, p = self.step, self.diagnostics, self.path
        frame_s, packs = [], []
        t_prev = time.perf_counter()
        with record_function("bench.pass"):
            st = self.pristine.replace(**{
                f: getattr(self.pristine, f).clone() for f in FIELDS})
            step.reset_fetches()
            if self.scene.params.integrator == "leapfrog":
                with record_function("bench.prime"):
                    st = step.prime(self.scene, st, method=p["method"],
                                    device=self.device)
            adv = step.make_audited_advance(
                self.scene, p["method"], self.spf,
                sort_every=p["sort_every"], slot_resident=p["slot_resident"],
                adaptive_cap=p["adaptive_cap"],
                membership_audit=p["membership_audit"], repair_k=p["repair_k"],
                packed_rows=p["packed_rows"], device=self.device)
            for k in range(self.frames):
                if starts is not None:
                    starts.append((st.x.clone(), st.active.clone()))
                with record_function("bench.advance"):
                    st = adv(st)
                with record_function("bench.fetch"):
                    packs.append(diag.scalars_dict(
                        diag.scalar_pack(st, self.scene.params)))
                t = time.perf_counter()
                frame_s.append(t - t_prev)
                t_prev = t
                for b in (keep or {}).get(k, ()):
                    for f in KEPT:
                        b[f].copy_(getattr(st, f))
        counters = {"fetches": step.FETCHES["fetches"],
                    "healed": getattr(adv, "healed", None),
                    "rebuilds": getattr(adv, "rebuilds", None),
                    "repaired": getattr(adv, "repaired", None)}
        return frame_s, packs, counters

    def frames_to_check(self, checks: list, packs: list) -> list:
        """(k, start, end, pack) of the checked frames, from the last pass."""
        const = {f: getattr(self.pristine, f) for f in ("kind", "emit_step")}
        seeded = {f: getattr(self.pristine, f) for f in FIELDS}
        return [(k, seeded if start is None else {**start, **const},
                 {**end, **const}, packs[k]) for k, start, end in checks]


def _pairs_by_frame(starts: list, h: float) -> list:
    """Pairs within h (self pairs included) and active particles of each
    frame's starting state, from the benchmark's own cell list."""
    out = []
    for x, act in starts:
        i, _ = pairs_within(x, act, h)
        out.append({"near": int(i.numel()), "particles": int(act.sum())})
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_proc0: float) -> dict | None:
    """One run; the result line's object, or None when a forbidden module
    was loaded (named on stderr)."""
    if _cuda(device):
        torch.cuda.set_device(device)
    prog = Program(cell, seed, device)
    keep, checks_kept = prog.new_keep(checked_frames(cell.workload, seed))
    prog.run_pass(keep)                       # warm-up: every shape, builds
    _sync(device)
    setup_peak = _peak(device)
    if _cuda(device):
        torch.cuda.reset_peak_memory_stats(device)

    frame_s, packs, pass_s, mallocs, host, counts = [], [], [], [], [], []
    t_start = time.perf_counter()
    setup_s = t_start - t_proc0
    while True:
        m0, h0 = _cuda_mallocs(device), _host()
        fs, pk, cn = prog.run_pass(keep)
        frame_s += fs
        packs.append(pk)
        pass_s.append(sum(fs))
        mallocs.append(_cuda_mallocs(device) - m0)
        host.append([b - a for a, b in zip(h0, _host())])
        counts.append(cn)
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    window_peak = _peak(device)
    if trace:
        # one more pass, under the profiler, after the window: the
        # profiler's own host cost stays out of the end-to-end metrics
        starts: list = []
        (fs, pk, counters), tr = trace_mod.profiled(
            lambda: prog.run_pass(keep, starts), _cuda(device))
        packs.append(pk)
        traced = SimpleNamespace(trace=tr, starts=starts, counters=counters)

    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return None

    passes = len(pass_s)
    kept = prog.frames_to_check(checks_kept, packs[-1])
    scene, spf, n_steps = prog.scene_dict, prog.spf, prog.frames * prog.spf
    expected = [prog.expected_active((k + 1) * spf) for k in range(prog.frames)]
    psteps = prog.particle_steps()
    del prog                                   # the program's state goes
    if _cuda(device):
        torch.cuda.empty_cache()

    device_info = {"platform": "gpu" if _cuda(device) else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if _cuda(device) else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))}
    all_packs = [pk for run in packs for pk in run]
    n_expected = expected * len(packs)
    result = {"correct": False, "attempted": len(all_packs), "failed": 0}
    if trace:
        tr = traced.trace
        obs = SimpleNamespace(
            trace=tr, counters=traced.counters, steps=n_steps,
            frames=len(traced.starts), dim=scene["params"]["dim"],
            pairs=_pairs_by_frame(traced.starts, scene["params"]["h"]),
            program_kernels=trace_mod.program_kernels(spec.ROOT))
        del traced
        metrics = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"])(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": trace_mod.top_device_ops(tr),
                     "idle_gaps": trace_mod.idle_gaps(tr)}
    else:
        steps_per_s = psteps * passes / window_s
        metrics = {
            "particle_steps_per_s": {"value": steps_per_s,
                                     "unit": "particle-steps/s"},
            "frame_ms_p90": {"value": statistics.quantiles(
                [s * 1e3 for s in frame_s], n=10, method="inclusive")[-1],
                "unit": "ms"},
            "peak_mem_gib": {"value": window_peak / 2**30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        metrics = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}

    checks = check.guarantees(all_packs, n_expected, scene,
                              cell.config["guarantees"])
    ref, bad_frames = check.reference_checks(kept, scene, spf,
                                             cell.workload["limits"], device)
    checks.update(ref)
    result["failed"] = bad_frames + sum(
        1 for pk, n in zip(all_packs, n_expected)
        if not check.healthy(pk, n, scene, cell.config["guarantees"]))
    result["correct"] = check.passed(checks)
    # beyond the result's metrics: each pass's seconds, the cudaMalloc
    # calls it made (whether set-up left anything to warm up), the
    # program's counters (whether the passes took the same decisions) and
    # the host's readings around it (`_host`)
    result.update(metrics=metrics, device=device_info,
                  window={"pass_s": pass_s, "mallocs": mallocs,
                          "host_cpu_s": [h[0] for h in host],
                          "host_nivcsw": [h[1] for h in host],
                          "host_steal_s": [h[2] for h in host],
                          "counters": counts,
                          "frame_ms": [round(f * 1e3, 2) for f in frame_s]})
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
