"""The roofline arithmetic and the trace's reading, on hand-built inputs."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark import trace as tr
from benchmark.metrics import _roofline as rl
from benchmark.reference.sph import pairs_within


def test_pairs_and_bytes_on_a_hand_built_state():
    # three particles on a line 0.5h and 0.9h apart (the outer two 1.4h),
    # a fourth active one far away, and an inactive one next to the first
    h = 10.0
    x = torch.tensor([[0.0, 0, 0], [5.0, 0, 0], [14.0, 0, 0], [100.0, 0, 0],
                      [1.0, 0, 0]])
    act = torch.tensor([True, True, True, True, False])
    i, j = pairs_within(x, act, h)
    pairs = sorted(zip(i.tolist(), j.tolist()))
    assert pairs == [(0, 0), (0, 1), (1, 0), (1, 1), (1, 2), (2, 1), (2, 2),
                     (3, 3)]
    near, n = len(pairs), int(act.sum())
    assert rl.density_ops(3, near) == 8 * 13
    assert rl.force_ops(3, near, n) == 4 * 39 + 2 * 4
    assert rl.density_bytes(3, n) == 4 * 20
    assert rl.force_bytes(3, n) == 4 * 44


def _trace(kernels, device, cpu, window, frame_ends):
    return tr.Trace(kernels=kernels,
                    device=np.asarray(device, np.int64).reshape(-1, 2),
                    cpu=cpu, window=window, frame_ends=frame_ends)


def test_roofline_share_by_frame():
    k1 = "void staged_kernel<3, float, false>(float const*, int)"
    k2 = "void staged_kernel<3, float, true>(float const*, int)"
    kernels = [(k1, 10, 1000), (k2, 20, 4000), (k2, 150, 2000),
               ("void other_kernel<3>(int)", 30, 500)]
    t = _trace(kernels, [(a, a + d) for _, a, d in kernels], [], (0, 300),
               [100, 300])
    pairs = [{"near": 1000, "particles": 100}, {"near": 3000, "particles": 100}]
    obs = SimpleNamespace(trace=t, pairs=pairs, dim=3, steps=10,
                          program_kernels={"staged_kernel"})
    want = 100 * (rl.bound_s(rl.force_ops(3, 1000, 100), rl.force_bytes(3, 100))
                  + rl.bound_s(rl.force_ops(3, 3000, 100),
                               rl.force_bytes(3, 100))) / 6000e-9
    assert spec.reader("k2_roofline_pct")(obs) == pytest.approx(want)
    assert spec.reader("k1_roofline_pct")(obs) == pytest.approx(
        100 * rl.bound_s(rl.density_ops(3, 1000), rl.density_bytes(3, 100))
        / 1000e-9)
    assert spec.reader("aten_ms_per_step")(obs) == pytest.approx(500e-6 / 10)
    obs.trace = _trace([], np.zeros((0, 2)), [], (0, 300), [300])
    assert spec.reader("k2_roofline_pct")(obs) is None


def test_busy_idle_and_gaps():
    cpu = [("bench.pass", 0, 1000), ("bench.advance", 0, 600),
           ("aten::nonzero", 300, 420), ("bench.fetch", 600, 1000)]
    t = _trace([("k", 100, 200), ("k", 250, 150)],
               [(100, 300), (250, 400), (700, 800)], cpu, (0, 1000),
               [1000])
    assert t.busy_s == pytest.approx(400e-9)
    assert t.window_s == pytest.approx(1000e-9)
    obs = SimpleNamespace(trace=t)
    assert spec.reader("device_idle_pct")(obs) == pytest.approx(60.0)
    gaps = dict(tr.idle_gaps(t))
    assert gaps == pytest.approx({"bench.advance": 100e-9 + 300e-9,
                                  "bench.fetch": 200e-9})
    assert tr.top_device_ops(t) == [["k", pytest.approx(350e-9)]]


def test_profiled_reads_the_spans():
    from torch.autograd.profiler import record_function

    def work():
        with record_function("bench.pass"):
            with record_function("bench.advance"):
                y = torch.randn(64).mul(2).sum()
            with record_function("bench.fetch"):
                return float(y)
    out, t = tr.profiled(work, cuda=False)
    assert isinstance(out, float)
    spans = [c[0] for c in t.cpu if c[0].startswith("bench.")]
    assert spans == ["bench.pass", "bench.advance", "bench.fetch"]
    assert "aten::mul" in {c[0] for c in t.cpu}
    assert t.window_s > 0 and len(t.frame_ends) == 1 and not t.kernels


def _event(name, t0, dur, cuda, annotation=False, tid=1):
    """A stand-in for one of the profiler's events."""
    from torch.autograd import DeviceType

    dev = DeviceType.CUDA if cuda else DeviceType.CPU
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: t0, duration_ns=lambda: dur,
        device_type=lambda: dev, is_user_annotation=lambda: annotation,
        start_thread_id=lambda: tid)


def test_device_events_are_told_apart_by_name():
    events = [
        _event("bench.pass", 0, 1000, False, True),
        _event("bench.fetch", 500, 500, False, True),
        _event("cudaLaunchKernel", 10, 5, False),
        _event("bench.pass", 0, 1000, True, True),      # span on the stream
        _event("", 900, 50, True),                       # a sync marker
        _event("void staged_kernel<3, float, true>(int)", 100, 200, True),
        _event("Memcpy DtoH (Device -> Pinned)", 950, 20, True),
        _event("Memset (Device)", 400, 10, True),
        _event("bench.advance", 0, 300, False, True, tid=2),   # other thread
    ]
    t = tr.read_events(events)
    assert t.window == (0, 1000) and t.frame_ends == [1000]
    assert [k[0] for k in t.kernels] == ["void staged_kernel<3, float, true>(int)"]
    assert t.device.tolist() == [[100, 300], [950, 970], [400, 410]]
    assert [c[0] for c in t.cpu] == ["bench.pass", "cudaLaunchKernel",
                                     "bench.fetch"]
    assert t.busy_s == pytest.approx(230e-9)


def test_program_kernels_are_found():
    names = tr.program_kernels(spec.ROOT)
    assert {"staged_kernel", "slot_pre_kernel", "slot_post_kernel",
            "warp_density_kernel", "stage_transpose_kernel"} <= names
