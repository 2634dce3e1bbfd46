"""Per-warp timeline of the warp K3/K4 (`csrc/packed_kernels.cu`) on a
packed state: where a launch's time goes.

    python -m sph_tpu_torch.trace_packed [checkpoint.npz]

builds the kernels with their trace hooks (`-DSPH_PACKED_TRACE`, a library
of its own; the library the paths run has none) and, at the checkpoint
(default: the committed settled emitters3d state), on the per-step lattice
and on the skinned lattice of `sort_every=4`, prints one JSON line per
kernel:

  graph_ms            the traced launch by CUDA-graph replay (the hooks cost
                      one clock read and, per warp, one 32-byte store)
  span_us             first warp start to last warp end of one launch
  live / dead         warps with lanes to compute, and without
  live_us             median, 90th percentile and longest live warp
  slowest             the longest live warps: row, chunk, candidates,
                      start and duration (us)
  candidates          per live warp: mean and most
  sm_load             candidates of the live warps summed per SM: most,
                      mean, and when the most loaded SM's last warp ends
  alone_ms, alone_us  the launch with only the row of the most candidates
                      live (every other warp dead, writing its zeros), by
                      graph replay, and that row's slowest warp: the work
                      one warp must do in order, without other live warps
  dead_ms             the launch with every warp dead: the grid's floor

No path calls this; it measures.  Times are the card's, with its name and
power limit printed first.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from sph_tpu_torch import _build, packed_kernels as pk
from sph_tpu_torch.slot_kernels import _raise_on

SETTLED = (Path(__file__).resolve().parent.parent / "bench"
           / ".settled_emitters3d_full.npz")


@contextlib.contextmanager
def traced_library():
    """The packed kernels' trace build, in place of the default build while
    the context lasts; yields its `packed_trace(buffer, only_row)`."""
    built = _build.build("packed_kernels", defines=("SPH_PACKED_TRACE",))
    built.lib.packed_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    built.lib.packed_trace.restype = ctypes.c_int
    saved = _build._LOADED.get("packed_kernels")
    _build._LOADED["packed_kernels"] = built
    try:
        yield built.lib.packed_trace
    finally:
        if saved is None:
            _build._LOADED.pop("packed_kernels")
        else:
            _build._LOADED["packed_kernels"] = saved


def graph_ms(fn, n: int = 20) -> float:
    """Device time per call of fn(), n calls replayed as one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timeline(fn, set_trace, units: int, only_row: int = -1) -> torch.Tensor:
    """[units, 4] int64 (start ns, end ns, SM, candidates or -1) of one
    launch of fn()."""
    buf = torch.full((units, 4), -1, dtype=torch.int64, device="cuda")
    _raise_on(set_trace(buf.data_ptr(), only_row), "packed_trace")
    fn()
    torch.cuda.synchronize()
    _raise_on(set_trace(None, -1), "packed_trace")
    return buf.cpu()


def summary(t: torch.Tensor, c_rows: int) -> dict:
    """What `timeline` says of one launch (see the module's docstring)."""
    u = torch.arange(t.shape[0])
    rows, chunks = u % c_rows, u // c_rows
    t0 = int(t[:, 0].min())
    start = (t[:, 0] - t0).double() / 1e3
    end = (t[:, 1] - t0).double() / 1e3
    dur = end - start
    live = t[:, 3] >= 0
    ld = dur[live]
    order = ld.argsort(descending=True)[:5]
    idx = live.nonzero().squeeze(1)[order]
    n_sm = int(t[:, 2].max()) + 1
    load = torch.zeros(n_sm, dtype=torch.float64).index_add_(
        0, t[live, 2], t[live, 3].double())
    busiest = int(load.argmax())
    on_busiest = live & (t[:, 2] == busiest)
    return {
        "span_us": float(end.max()),
        "live": int(live.sum()), "dead": int((~live).sum()),
        "live_us": {"median": float(ld.median()),
                    "p90": float(ld.quantile(0.9)), "max": float(ld.max())},
        "slowest": [{"row": int(rows[i]), "chunk": int(chunks[i]),
                     "candidates": int(t[i, 3]),
                     "start_us": float(start[i]), "us": float(dur[i])}
                    for i in idx.tolist()],
        "candidates": {"mean": float(t[live, 3].double().mean()),
                       "max": int(t[live, 3].max())},
        "sm_load": {"max": float(load.max()), "mean": float(load.mean()),
                    "busiest_sm_ends_us": float(end[on_busiest].max())},
    }


def trace_lattice(scene, state, grid, lattice: str) -> None:
    from sph_tpu_torch import pallas_step as ps

    sg = ps.packed_grid(grid)
    addr = ps.build_addr(state.x, state.active, grid, sg)
    feat = ps.scatter_slots(addr, ps._pack_rows6(state.x, state.v), sg)
    jb = ps._jblocks(addr, sg)
    args = (addr.n_occ, addr.nbr_pos, jb, addr.gcounts, scene.params)
    rp = pk.packed_density(feat, *args)
    c_rows, _, lanes = feat.shape
    units = c_rows * lanes // 32
    with traced_library() as set_trace:
        for name, fn in (("K3", lambda: pk.packed_density(feat, *args)),
                         ("K4", lambda: pk.packed_force(feat, rp, *args))):
            t = timeline(fn, set_trace, units)
            out = {"lattice": lattice, "kernel": name,
                   "graph_ms": graph_ms(fn), **summary(t, c_rows)}
            heaviest = int(t[:, 3].argmax()) % c_rows
            _raise_on(set_trace(None, heaviest), "packed_trace")
            out["alone_row"] = heaviest
            out["alone_ms"] = graph_ms(fn)
            alone = timeline(fn, set_trace, units, heaviest)
            live = alone[:, 3] >= 0
            out["alone_us"] = float(
                ((alone[live, 1] - alone[live, 0]).double() / 1e3).max())
            _raise_on(set_trace(None, 0), "packed_trace")  # row 0: all dead
            out["dead_ms"] = graph_ms(fn)
            _raise_on(set_trace(None, -1), "packed_trace")
            print(json.dumps(out), flush=True)


def main(path: str = str(SETTLED)) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the trace times the card's kernels: no CUDA device")
    import sph_tpu_torch as sph
    from sph_tpu_torch import neighbors

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    state, scene = sph.load_checkpoint(path, device=dev)
    base = neighbors.GridSpec.for_scene(scene)
    skinned = neighbors.GridSpec.for_scene(
        scene, cap=base.cap, skin=sph.default_skin(scene, 4))
    trace_lattice(scene, state, base, "per step")
    trace_lattice(scene, state, skinned, "sort_every=4")


if __name__ == "__main__":
    main(*sys.argv[1:2])
