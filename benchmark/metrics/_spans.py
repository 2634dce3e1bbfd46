"""The program's own spans (`sph.*`, `sph_tpu_torch.platform.span`) in the
traced pass, and the device kernels each span launched.

The profiler puts the spans, the host's CUDA launch calls and the device's
kernels on one clock.  The port runs on one stream, so the n-th launch
call of the pass's thread issues the n-th kernel by start time:

- as many launch calls as kernels: every kernel is paired;
- as many launch calls as kernels that are not the program's own
  (`obs.program_kernels`): the profiler did not see the launches of the
  program's libraries, which link the CUDA runtime statically, so only
  PyTorch's kernels are paired;
- otherwise the pairing is not known, and the readers return None.

A kernel belongs to a span name when its launch call starts inside a span
of that name, however deeply nested.  The trace of a program without
these spans holds none of them, and the readers then return None.
"""

from __future__ import annotations

import re

import numpy as np

LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel")


def spans(tr, *names) -> np.ndarray:
    """[n, 2] start, end of the pass thread's spans named one of `names`,
    merged where they overlap or nest, in order."""
    iv = np.asarray([(a, b) for n, a, b in tr.cpu if n in names],
                    np.int64).reshape(-1, 2)
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    last = np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]
    return np.stack([iv[new, 0], ends[last]], 1)


def inside(t: np.ndarray, iv: np.ndarray) -> np.ndarray:
    """[len(t)] bool: each time in `t` lies inside a merged interval."""
    if not len(iv):
        return np.zeros(len(t), bool)
    k = np.searchsorted(iv[:, 0], t, side="right") - 1
    return (k >= 0) & (t <= iv[np.maximum(k, 0), 1])


def launched(obs):
    """(launch call starts, kernel durations) of the paired kernels, both
    [n] int64 ns in launch order, or None when the pairing is not known."""
    tr = obs.trace
    calls = sorted(a for n, a, _ in tr.cpu if n.startswith(LAUNCH))
    kern = sorted(tr.kernels, key=lambda k: k[1])
    if not kern:
        return None
    if len(calls) != len(kern) and obs.program_kernels:
        own = re.compile(r"\b(" + "|".join(sorted(obs.program_kernels))
                         + r")\b")
        kern = [k for k in kern if not own.search(k[0])]
    if len(calls) != len(kern):
        return None
    return (np.asarray(calls, np.int64),
            np.asarray([d for _, _, d in kern], np.int64))


def device_ms_per_step(obs, *names) -> float | None:
    """Device ms a step of the kernels launched inside spans of `names`;
    None when the pass holds no such span or its kernels cannot be
    paired with their launches."""
    iv = spans(obs.trace, *names)
    got = launched(obs)
    if not len(iv) or got is None:
        return None
    t, dur = got
    return float(dur[inside(t, iv)].sum()) * 1e-6 / obs.steps


def host_ms_per_step(obs, *names) -> float | None:
    """Host ms a step inside spans of `names`; None without such a span."""
    iv = spans(obs.trace, *names)
    if not len(iv):
        return None
    return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-6 / obs.steps


def idle_ms_per_step(obs, *names) -> float | None:
    """Device idle ms a step, inside the pass, of the gaps between device
    activity whose midpoint lies inside a span of `names`; None without
    such a span."""
    tr = obs.trace
    iv = spans(tr, *names)
    if not len(iv):
        return None
    busy = tr.busy_intervals()
    lo, hi = tr.window
    edges = (np.r_[lo, busy.ravel(), hi].reshape(-1, 2) if len(busy)
             else np.array([[lo, hi]], np.int64))
    gaps = edges[edges[:, 1] > edges[:, 0]]
    mids = (gaps[:, 0] + gaps[:, 1]) // 2
    sel = inside(mids, iv)
    return float((gaps[sel, 1] - gaps[sel, 0]).sum()) * 1e-6 / obs.steps
