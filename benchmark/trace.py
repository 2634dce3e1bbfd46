"""The device trace of one pass: torch.profiler (CUPTI) over the pass, read
into plain lists, and what the per-layer readers and the breakdown take
from it.

The harness marks its own host spans with `record_function`: `bench.pass`
around a whole pass, `bench.prime`, `bench.advance` (one call of the
program's advance, a frame) and `bench.fetch` (the frame's diagnostics
read back).  Device and host events share the profiler's clock.

The device's busy time and the window it is measured against both come
from the one traced pass, profiler overhead included: on a host-paced
pass that overhead is idle time of the device.  The profiler records
every PyTorch operation on the host, so that an idle gap is named by the
operation the host was in.  Recording only the spans was tried: on the
per-step path at 1.08M particles it lengthened a pass by 5.6-7.2 s where
the full recording adds about 9 s (H100 host), so it would not make the
idle share that of an untraced pass either.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

SPANS = ("bench.pass", "bench.prime", "bench.advance", "bench.fetch")


def _device_kind(e, name: str) -> str:
    """'kernel', 'gpu_memcpy', 'gpu_memset' or 'other' for an event on the
    device's timeline, which also holds the harness's spans projected onto
    the stream (user annotations) and unnamed sync markers.  The kind
    follows from the name: the profiler's events carry no activity type in
    the PyTorch the chip runs (2.11)."""
    if not name or name in SPANS or e.is_user_annotation():
        return "other"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


@dataclass
class Trace:
    kernels: list                 # (name, start_ns, dur_ns) of device kernels
    device: np.ndarray            # [n, 2] start, end of every device activity
    cpu: list                     # (name, start_ns, end_ns), the pass's thread
    window: tuple                 # (start_ns, end_ns) of bench.pass
    frame_ends: list = field(default_factory=list)   # end of each bench.fetch

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> np.ndarray:
        """The union of device activity inside the window, as merged
        [start, end] rows."""
        lo, hi = self.window
        iv = np.clip(self.device, lo, hi)
        iv = iv[iv[:, 1] > iv[:, 0]]
        if not len(iv):
            return iv
        iv = iv[np.argsort(iv[:, 0])]
        ends = np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(iv), bool)
        new[1:] = iv[1:, 0] > ends[:-1]
        starts = iv[new, 0]
        last = np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]
        return np.stack([starts, ends[last]], 1)

    @property
    def busy_s(self) -> float:
        b = self.busy_intervals()
        return float((b[:, 1] - b[:, 0]).sum()) * 1e-9 if len(b) else 0.0

    def frame_of(self, t_ns: int) -> int:
        """The frame whose work a device event starting at `t_ns` belongs
        to: each frame ends in a fetch that waits for the device."""
        return min(bisect.bisect_right(self.frame_ends, t_ns),
                   len(self.frame_ends) - 1)


def profiled(fn, cuda: bool):
    """(fn(), the Trace of the call): `fn` run under torch.profiler, with
    the device's activity where `cuda`."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    return out, read_events(prof.profiler.kineto_results.events())


def read_events(events) -> Trace:
    """A Trace from the profiler's events around one pass."""
    from torch.autograd import DeviceType

    kernels, device, cpu = [], [], []
    window, tid = None, None
    for e in events:
        name, t0, dur = e.name(), e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            kind = _device_kind(e, name)
            if kind in ("kernel", "gpu_memcpy", "gpu_memset"):
                device.append((t0, t0 + dur))
                if kind == "kernel":
                    kernels.append((name, t0, dur))
        else:
            cpu.append((name, t0, t0 + dur, e.start_thread_id()))
            if name == "bench.pass":
                window, tid = (t0, t0 + dur), e.start_thread_id()
    if window is None:
        raise RuntimeError("the profile holds no bench.pass span")
    cpu = sorted(((n, a, b) for n, a, b, t in cpu if t == tid),
                 key=lambda c: (c[1], -c[2]))
    ends = sorted(b for n, a, b in cpu if n == "bench.fetch")
    return Trace(kernels=kernels,
                 device=np.asarray(device, np.int64).reshape(-1, 2),
                 cpu=cpu, window=window, frame_ends=ends)


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, its argument list and
    `(anonymous namespace)::`."""
    name = kernel.replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.removeprefix("void ")[:160]


def top_device_ops(tr: Trace, n: int = 10) -> list:
    """[name, seconds] of the device kernels that took most time."""
    tot: dict = {}
    for name, _, dur in tr.kernels:
        k = short_name(name)
        tot[k] = tot.get(k, 0) + dur
    return [[k, v * 1e-9] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(tr: Trace, n: int = 10) -> list:
    """[what the host was doing, seconds]: the device's idle time inside
    the window, summed by the harness span and the CUDA runtime call that
    were open at the middle of each gap (the span alone where the host was
    in Python between calls)."""
    busy = tr.busy_intervals()
    lo, hi = tr.window
    edges = np.r_[lo, busy.ravel(), hi].reshape(-1, 2) if len(busy) else \
        np.array([[lo, hi]])
    gaps = edges[edges[:, 1] > edges[:, 0]]
    mids = (gaps[:, 0] + gaps[:, 1]) // 2
    order = np.argsort(mids)
    labels = [""] * len(gaps)
    stack: list = []
    ci = 0
    for g in order:
        t = mids[g]
        while ci < len(tr.cpu) and tr.cpu[ci][1] <= t:
            while stack and stack[-1][2] < tr.cpu[ci][1]:
                stack.pop()
            stack.append(tr.cpu[ci])
            ci += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        live = [c for c in stack if c[2] >= t]
        span = next((c[0] for c in reversed(live) if c[0] in SPANS), "host")
        inner = live[-1][0] if live and live[-1][0] not in SPANS else ""
        labels[g] = f"{span} > {inner}" if inner else span
    tot: dict = {}
    for lab, (a, b) in zip(labels, gaps):
        tot[lab] = tot.get(lab, 0) + int(b - a)
    return [[k, v * 1e-9] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def program_kernels(root: Path) -> set:
    """The names of the program's own CUDA kernels (`__global__` functions
    of `sph_tpu_torch/csrc/*.cu`)."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                     r"(\w+)\s*\(")
    names = set()
    for f in sorted((root / "sph_tpu_torch" / "csrc").glob("*.cu")):
        names.update(pat.findall(f.read_text()))
    return names
