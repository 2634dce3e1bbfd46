"""The benchmark's cap-8 cell, `splash3d_1m-cap8.early`: the cap-8 adaptive
policy (`make_audited_advance(..., adaptive_cap=True)`) as the benchmark
runs it, against its plain reference on the CPU.

- The configuration is `splash3d_1m`'s scene, parameters and guarantees
  with only `path.adaptive_cap` set; its cell and five readers are entries
  of `BENCHMARK.json` of their own.
- The small cut of the configuration (`benchmark/tests/small.py`) run by
  `harness.run_cell` with its traced pass is `correct`, in a process of its
  own (`torch_bench_cap8_worker.py`): a calm column that holds cap 8, and a
  column thrown at the floor whose dispatch from step 16 outgrows cap 8.
- The traced pass holds the policy's spans (`sph.cap8`, `sph.cap_probe`),
  `cap8_block_pct` agrees with `.cap8_blocks`, and the spans leave the
  state and the counters bit for bit as an untraced pass has them.
- The readers on hand-built traces: the launches inside `sph.cap8` and
  outside its heals, and None on a trace without the policy's spans.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import spec
from benchmark import trace as trace_mod
from benchmark.metrics import _roofline as rl

ROOT = Path(__file__).resolve().parents[1]
CELL = "splash3d_1m-cap8.early"
READERS = ("cap8_block_pct", "cap8_k2_roofline_pct", "cap8_k1_roofline_pct",
           "cap8_heal_ms_per_step", "cap_probe_ms_per_step")


@pytest.fixture(scope="module")
def runs():
    """{case: the worker's JSON line}, both cases run side by side."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    worker = str(Path(__file__).with_name("torch_bench_cap8_worker.py"))
    procs = {case: subprocess.Popen(
        [sys.executable, worker, case], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for case in ("calm", "switch")}
    out = {}
    for case, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{case}: {stderr[-4000:]}"
        out[case] = json.loads(stdout.strip().splitlines()[-1])
    return out


def test_configuration_is_the_splash_with_the_cap8_flag():
    bench = spec.load_benchmark()
    cell = spec.load_cell(CELL)
    base = spec.load_cell("splash3d_1m.impact").config
    cfg = cell.config
    assert cell.chips == 1
    assert (cfg["scene"], cfg["guarantees"], cfg["reference"]) == (
        base["scene"], base["guarantees"], base["reference"])
    assert cfg["path"] == {**base["path"], "adaptive_cap": True}
    assert not base["path"]["adaptive_cap"]
    (entry,) = [c for c in bench["configs"] if c["name"] == cfg["name"]]
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    assert len(entry["source"]) <= 200


def test_cell_arc_checks_and_metrics():
    bench = spec.load_benchmark()
    cell = spec.load_cell(CELL)
    w = cell.workload
    assert (w["steps"], w["steps_per_frame"]) == (500, 100)
    assert w["check"]["draw"] == [[1, 2], [3, 4]]
    assert w["limits"] == spec.load_cell("splash3d_1m.fall").workload["limits"]
    assert [m["name"] for m in cell.end_to_end] == ["particle_steps_per_s",
                                                   "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    for m in cell.per_layer:
        assert m["workloads"] == [CELL]
        assert m["moves"] == "particle_steps_per_s"
    layers = {m["layer"] for m in bench["per_layer"]
              if m["name"] not in READERS}
    assert {m["layer"] for m in cell.per_layer} <= layers
    for other in ("splash3d_1m.impact", "splash3d_1m-perstep.impact",
                  "splash3d_1m.fall"):
        names = {m["name"] for m in spec.load_cell(other).per_layer}
        assert not names & set(READERS), other


@pytest.mark.parametrize("case", ["calm", "switch"])
def test_small_cell_is_correct_against_the_plain_reference(runs, case):
    r = runs[case]
    assert r["correct"], r["checks"]
    assert r["checks"]["lost"]["value"] == 0
    for name in ("x_gap", "v_gap", "rho_gap", "diag_gap"):
        assert r["checks"][name]["value"] < r["checks"][name]["limit"], name


@pytest.mark.parametrize("case,mode,switch_step,cap8_frames", [
    ("calm", "cap8", None, [1, 1]),
    ("switch", "cap16", 24, [1, 1, 1, 0]),
])
def test_spans_and_block_share_agree_with_the_counters(runs, case, mode,
                                                       switch_step,
                                                       cap8_frames):
    r = runs[case]
    traced = r["passes"][-1]
    assert (traced["mode"], traced["switch_step"]) == (mode, switch_step)
    assert r["spans"]["sph.cap_probe"] == 1
    assert r["cap8_spans_in_frames"] == cap8_frames
    assert r["spans"]["sph.cap8"] == sum(cap8_frames)
    assert r["spans"]["sph.block"] == traced["blocks"]
    assert traced["cap8_blocks"] == 2 * sum(cap8_frames)
    pct = r["metrics"]["cap8_block_pct"]
    assert pct == pytest.approx(
        100.0 * traced["cap8_blocks"] / traced["blocks"])
    assert (pct == 100.0) == (switch_step is None)
    assert r["metrics"]["cap_probe_ms_per_step"] > 0
    if switch_step is not None:
        assert traced["healed"] >= 2 and r["spans"]["sph.heal"] >= 2


@pytest.mark.parametrize("case", ["calm", "switch"])
def test_spans_leave_state_and_counters_bitwise(runs, case):
    warm, window, traced = runs[case]["passes"]
    assert warm == window
    keys = ("healed", "rebuilds", "repaired", "cap8_blocks", "switch_step",
            "mode", "blocks")
    assert {k: window[k] for k in keys} == {k: traced[k] for k in keys}
    assert window["digest"] == traced["digest"]


# --- the readers on hand-built traces --------------------------------------

K1 = "void staged_kernel<3, float, false>(float const*, int)"
K2 = "void staged_kernel<3, float, true>(float const*, int)"
FILL = "void at::native::vectorized_elementwise_kernel<4>(int, float)"

# two frames: the first a dispatch on the cap-8 lattice (after the probe),
# one block and a heal that re-runs K2; the second on cap 16, one block
CPU_SPANS = [("bench.pass", 0, 2000),
             ("bench.advance", 0, 940), ("bench.fetch", 940, 960),
             ("sph.cap_probe", 2, 12), ("sph.cap8", 20, 900),
             ("sph.block", 100, 300), ("sph.heal", 400, 600),
             ("bench.advance", 1000, 1940), ("bench.fetch", 1940, 1960),
             ("sph.block", 1100, 1300)]
KERNELS = [(K1, 120, 50), (K2, 200, 100), (FILL, 430, 10), (K2, 450, 80),
           (K1, 1150, 60), (K2, 1200, 90)]
LAUNCH_AT = (105, 110, 410, 420, 1105, 1110)
PAIRS = [{"near": 900_000, "particles": 40_000},
         {"near": 700_000, "particles": 30_000}]


def _obs(cpu=CPU_SPANS, kernels=KERNELS, launches=LAUNCH_AT, steps=8):
    cpu = cpu + [("cudaLaunchKernel", t, t + 5) for t in launches]
    tr = trace_mod.Trace(
        kernels=kernels,
        device=np.asarray([(a, a + d) for _, a, d in kernels],
                          np.int64).reshape(-1, 2),
        cpu=sorted(cpu, key=lambda c: (c[1], -c[2])), window=(0, 2000),
        frame_ends=[960, 1960])
    return SimpleNamespace(trace=tr, steps=steps, dim=3, pairs=PAIRS,
                           program_kernels={"staged_kernel"},
                           counters={})


def _read(name, obs):
    return spec.reader(name)(obs)


def test_readers_take_the_launches_inside_cap8():
    obs = _obs()
    fp = PAIRS[0]
    k2 = rl.bound_s(rl.force_ops(3, fp["near"], fp["particles"]),
                    rl.force_bytes(3, fp["particles"]))
    k1 = rl.bound_s(rl.density_ops(3, fp["near"]),
                    rl.density_bytes(3, fp["particles"]))
    # the heal's K2 (launched at 420, inside `sph.heal`) re-runs the block
    # on the per-step path's grid: not a launch on the cap-8 lattice
    assert _read("cap8_k2_roofline_pct", obs) == pytest.approx(
        100 * k2 / 100e-9)
    assert _read("cap8_k1_roofline_pct", obs) == pytest.approx(
        100 * k1 / 50e-9)
    assert _read("cap8_heal_ms_per_step", obs) == pytest.approx(
        90 * 1e-6 / 8)
    assert _read("cap8_block_pct", obs) == pytest.approx(50.0)
    assert _read("cap_probe_ms_per_step", obs) == pytest.approx(10e-6 / 8)
    # the whole pass's K2 share counts the cap-16 frame's launch too
    assert _read("k2_roofline_pct", obs) != pytest.approx(
        _read("cap8_k2_roofline_pct", obs))


def test_readers_give_none_without_the_policys_spans():
    parent = [s for s in CPU_SPANS
              if s[0] not in ("sph.cap8", "sph.cap_probe")]
    for name in READERS:
        assert _read(name, _obs(cpu=parent)) is None, name
    # launches the profiler did not pair: no share, no heal time
    unpaired = _obs(launches=LAUNCH_AT[:-1])
    assert _read("cap8_k2_roofline_pct", unpaired) is None
    assert _read("cap8_heal_ms_per_step", unpaired) is None
    assert _read("cap8_block_pct", unpaired) == pytest.approx(50.0)
