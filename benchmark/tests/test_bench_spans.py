"""The readers of the program's spans (`metrics/_spans.py` and the six
metrics on it), on hand-built traces."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import spec
from benchmark import trace as tr
from benchmark.metrics import _spans

K1 = "void staged_kernel<3, float, false>(float const*, int)"
SCAN = "void at::native::tensor_kernel_scan_innermost_dim<long>(long*)"
SORT = "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>(int*)"
FILL = "void at::native::vectorized_elementwise_kernel<4>(int, float)"


def _obs(kernels, cpu, window=(0, 1000), device=None, steps=10):
    if device is None:
        device = [(a, a + d) for _, a, d in kernels]
    t = tr.Trace(kernels=kernels,
                 device=np.asarray(device, np.int64).reshape(-1, 2),
                 cpu=sorted(cpu, key=lambda c: (c[1], -c[2])),
                 window=window, frame_ends=[window[1]])
    return SimpleNamespace(trace=t, steps=steps,
                           program_kernels={"staged_kernel",
                                            "slot_pre_kernel"})


def _launch(t):
    return ("cudaLaunchKernel", t, t + 5)


# a pass: a rebuild (build_addr's sort, a scatter's fill), a block (K1),
# a repair (its scan, then a fetch), a gather outside every policy span
SPANS = [("bench.pass", 0, 1000), ("sph.rebuild", 10, 200),
         ("sph.build_addr", 20, 100), ("sph.scatter", 110, 190),
         ("sph.block", 300, 500), ("sph.repair", 600, 800),
         ("sph.fetch", 700, 790), ("sph.gather", 850, 900)]
KERNELS = [(SORT, 60, 40), (FILL, 150, 30), (K1, 320, 100),
           (SCAN, 630, 50), (FILL, 870, 20)]
LAUNCHES = [_launch(t) for t in (30, 120, 310, 610, 860)]


def _read(name, obs):
    return spec.reader(name)(obs)


def test_pairing_when_every_launch_is_seen():
    obs = _obs(KERNELS, SPANS + LAUNCHES)
    t, dur = _spans.launched(obs)
    assert t.tolist() == [30, 120, 310, 610, 860]
    assert dur.tolist() == [40, 30, 100, 50, 20]
    ms = 1e-6 / 10
    assert _read("repair_ms_per_step", obs) == pytest.approx(50 * ms)
    assert _read("rebuild_ms_per_step", obs) == pytest.approx(70 * ms)
    assert _read("addressing_ms_per_step", obs) == pytest.approx(90 * ms)
    assert _read("heal_ms_per_step", obs) is None     # the pass healed none


def test_pytorch_kernels_alone_when_the_programs_launches_are_unseen():
    # K1's launch comes from the program's library: the profiler missed it
    launches = [c for c in LAUNCHES if c[1] != 310]
    obs = _obs(KERNELS, SPANS + launches)
    t, dur = _spans.launched(obs)
    assert t.tolist() == [30, 120, 610, 860]
    assert dur.tolist() == [40, 30, 50, 20]
    assert _read("repair_ms_per_step", obs) == pytest.approx(50e-6 / 10)
    assert _read("addressing_ms_per_step", obs) == pytest.approx(90e-6 / 10)


def test_no_reading_without_a_pairing_or_without_kernels():
    obs = _obs(KERNELS, SPANS + LAUNCHES[:2])
    assert _spans.launched(obs) is None
    for name in ("repair_ms_per_step", "rebuild_ms_per_step",
                 "heal_ms_per_step", "addressing_ms_per_step"):
        assert _read(name, obs) is None, name
    obs = _obs([], SPANS, device=np.zeros((0, 2)))
    assert _spans.launched(obs) is None
    assert _read("rebuild_ms_per_step", obs) is None
    # a program without the spans: every reader reads nothing
    bare = [c for c in SPANS if not c[0].startswith("sph.")]
    obs = _obs(KERNELS, bare + LAUNCHES)
    for name in ("repair_ms_per_step", "rebuild_ms_per_step",
                 "heal_ms_per_step", "addressing_ms_per_step",
                 "fetch_wait_ms_per_step", "block_idle_ms_per_step"):
        assert _read(name, obs) is None, name


def test_attribution_includes_nested_spans():
    # a heal re-runs steps whose addressing nests two levels down; a
    # second heal overlaps the first's end (merged, counted once)
    spans = [("bench.pass", 0, 1000), ("sph.heal", 100, 400),
             ("sph.heal", 350, 450), ("sph.build_addr", 120, 300),
             ("sph.gather", 200, 250)]
    kernels = [(SORT, 150, 10), (SCAN, 230, 20), (FILL, 420, 30),
               (FILL, 600, 40)]
    obs = _obs(kernels, spans + [_launch(t) for t in (130, 210, 440, 500)])
    assert _read("heal_ms_per_step", obs) == pytest.approx(60e-6 / 10)
    assert _read("addressing_ms_per_step", obs) == pytest.approx(30e-6 / 10)
    iv = _spans.spans(obs.trace, "sph.heal")
    assert iv.tolist() == [[100, 450]]
    assert _spans.inside(np.array([99, 100, 450, 451]), iv).tolist() == [
        False, True, True, False]


def test_idle_gaps_go_to_the_block_by_their_midpoint():
    # device busy 0-100, 200-300, 700-800 of a 0-1000 pass: gaps 100-200
    # (mid 150, in the block), 300-700 (mid 500, outside) and 800-1000
    # (mid 900, in the second block)
    spans = [("bench.pass", 0, 1000), ("sph.block", 120, 180),
             ("sph.block", 850, 950)]
    obs = _obs([(K1, 0, 100)], spans,
               device=[(0, 100), (200, 300), (700, 800)])
    assert _read("block_idle_ms_per_step", obs) == pytest.approx(
        (100 + 200) * 1e-6 / 10)
    obs = _obs([(K1, 0, 100)], spans, device=np.zeros((0, 2)))
    assert _read("block_idle_ms_per_step", obs) == 0.0    # mid 500: outside


def test_fetch_wait_sums_the_fetch_spans():
    spans = [("bench.pass", 0, 1000), ("sph.fetch", 100, 160),
             ("sph.fetch", 400, 440), ("sph.repair", 380, 500)]
    obs = _obs([], spans, device=np.zeros((0, 2)), steps=4)
    assert _read("fetch_wait_ms_per_step", obs) == pytest.approx(
        100e-6 / 4)


def test_the_benchmark_declares_the_readers():
    names = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in ("repair_ms_per_step", "rebuild_ms_per_step",
                 "heal_ms_per_step", "addressing_ms_per_step",
                 "fetch_wait_ms_per_step", "block_idle_ms_per_step"):
        assert names[name]["source"] == "device_trace"
        assert names[name]["workloads"]
        assert callable(spec.reader(name))
