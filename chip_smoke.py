#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`sph_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

  1. card     nvidia-smi name and power limit, torch and CUDA versions
  2. build    nvcc builds of the slot and the packed-row kernels from csrc/
              (side by side), with the -Xptxas -v register/spill lines, and
              per K1/K2 and K3/K4 kernel its registers, spills, shared
              memory and block size (K3/K4: the warp kernels' default
              launch choices)
  3. kernels  at dam3d_100k and splash3d_1m (the slot arrays of step 0):
              K1 and K2 against their plain PyTorch versions on the same
              inputs (rho rtol 1e-5 atol 1e-6 per particle; f max-relative
              3e-5 — the reference suite's own tolerances between its paths,
              summation order differs), and bitwise against their simple
              yardsticks (`slot_*_simple`, the first design), times of the
              two in turns (launched from the host, as every kernel is
              timed, and as a CUDA-graph replay), the bound (operations the
              function needs: the full pair arithmetic only within h), and
              the histogram of live i-slots per live 128-lane group; then the
              same on the skinned lattice of sort_every=4 (the resident
              arrays)
  4. kernels  at emitters3d@settled (the committed checkpoint of step
              260,000): K3 and K4 against their plain versions at the same
              tolerances and bitwise their simple yardsticks
              (`packed_*_simple`, the first design), times of the two in
              turns by both methods, of K1, K2 (with their yardsticks,
              bitwise) on the slot layout of the same state, their bounds,
              and the time of the smallest launch; then the sweep of the
              warp K3/K4's launch choices (warps a block, tile, prefetch,
              band test), each bitwise the default, timed by graph
              replay in turns.  K3 and K4 twice, at the shapes of both
              packed paths: addressing built on the per-step lattice, and on
              the skinned lattice of sort_every=4 (wider rows, more
              multi-block rows)
  5. path     run(preset("dam3d_100k"), 200, method="pallas") on the card:
              finite state, no cap overflow, mean rho/rho0 of the fluid in
              [0.90, 1.10], max|v| < 500, and each kernel launched exactly
              201 times (200 steps + prime); ms/step and peak memory
  6. path     the same at splash3d_1m for 20 steps
  7. path     emitters3d@settled, run(..., 200, packed_rows=True): finite
              state, no cap overflow, max|v| < 3 c0, no particle lost, K3
              and K4 launched exactly 200 times (no prime at step 260,000)
              and K1/K2 never
  8. path     the same with sort_every=4 (address reuse): the same checks,
              the launch counts its two 100-step dispatches imply, and the
              audit's violation notes (an exact re-run passes: it is the
              policy working)
  9. agreement  20 per-step steps from the checkpoint, packed rows against
              the slot layout: x within 1e-3 h
 10. determinism  two 20-step dam3d_100k runs, and two 200-step packed
              emitters3d runs, give bitwise-equal x
 11. no_sync  two dam3d_100k steps, and one 4-step packed reuse block, under
              torch's sync debug mode "error": a step never waits on the host
 12. profile  torch.profiler over steps at the three sizes, and over one
              sort_every=4 packed dispatch: device time per step by kernel,
              operations per step, the device's busy share of the wall time
 13. kernels  K5 at dam3d_100k and splash3d_1m on the step-0 slot addressing
              with the resident path's 7 scatter columns: K5 against its
              plain version and scatter_slots(staged=True) against the
              direct scatter, both bitwise; times of K5, its plain version,
              PyTorch's own transpose copy, and the whole staged and direct
              scatters; the bound.  Then the path of K5's entry point:
              scatter_slots(staged=True) once at each size, one launch each
 14. path     the production default, run(scene, n, method="pallas",
              sort_every=4, slot_resident=True), from init at dam3d_100k
              (200 steps) and splash3d_1m (20 steps, repair_k resolving to
              2048), with the health checks of phases 5-6, the policy's
              counters (healed, repaired, rebuilds, mode), the host fetches
              per block, and K1/K2 launched 1 + steps + 4 per healed block
 15. path     the same from the settled emitters3d checkpoint (200 steps,
              packed_rows=None): the packed auto policy's verdict, checked
              against packed_fits on the same state, and the launches it
              implies; then pinned packed rows (packed_rows=True) resident
 16. agreement  20 resident4auto steps against 20 non-resident reuse steps
              at dam3d_100k with repair_k=0: x within 1e-3 h
 17. determinism  two 20-step resident4auto dam3d_100k runs: bitwise-equal x
 18. profile  one 12-step resident4auto dispatch at dam3d_100k and at
              splash3d_1m: device time per step by kernel, operations per
              step, busy share, host fetches per block
 19. kernels  precision="bf16" at dam3d_100k and splash3d_1m (step-0 slot
              arrays, bf16 cell-relative features): the bf16 K1/K2 against
              their plain versions at phase 3's tolerances and bitwise
              their yardsticks, times in turns, bounds (features at 2 B);
              per particle against the fp32 kernels within the reference's bf16 tolerances (rho rtol 2e-2, f
              within 6e-2 of the fp32 force scale, tests/test_bf16.py)
 20. kernels  xsub=2 at dam3d_100k: K1/K2 with the xsub margin against their
              plain versions and bitwise their yardsticks, times, bounds
 21. path     bf16 per step and bf16 resident4auto at dam3d_100k (200
              steps) and splash3d_1m (20), with the health checks of phases
              5-6 and 14, repair_k resolving to 0, and the bf16 kernels
              launched as the plan implies (the fp32 ones never)
 22. agreement  bf16 at dam3d_100k: the classic resident block against
              reuse after 20 steps, x and rho bitwise with no overflow; bf16
              against fp32 (resident4auto) after 20 steps, max|dx| < h/16
 23. path     at dam3d_100k, 200 steps each: the packed_scatter transport
              (its own loop over make_advance(..., auto_rebuild=True,
              packed_scatter=True), which run does not take), xsub=2 per
              step and resident4auto, and row_pair resident4auto, with
              health, counters and launches
 24. agreement  20 steps at dam3d_100k against the default: row_pair per
              step and resident bitwise; xsub=2 resident within 1e-3 h;
              packed_scatter within 3 x 2^-10 cell and rho within 1%
              (one bf16 round trip of a cell-relative x, |x - center| <
              cell/2, is at most 2^-10 cell; in the absolute frame it is
              up to 0.5 at x ~ 160)
 25. kernels  P1: the fp32 and packed-bf16 probe kernels bitwise against
              the plain chain on U[0,1) inputs (finite) and on the probe's
              own (all inf); its entry point's timing run (50 calls a
              dtype, replayed as a CUDA graph; the direct launches beside),
              ms, Top/s, ratio, bound; the SASS opcode counts of
              both kernels (cuobjdump -sass): packed bf16 instructions in
              the bf16 kernel, no FFMA in the fp32 one
  then the {"kernels": [...]} summary, the nvidia-smi line, and last
  {"ok": true, "device": {...}}.

Every path reads its launch counts through `read_counts`, which checks that
no yardstick and no variant of a launch choice ran in it.  Any failed check
raises and the script exits non-zero without the last line.  It imports
neither JAX nor `sph_tpu`.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# fp32 operations the function needs, counted from the kernel source, per
# candidate pair of real particles on the per-step lattice (a particle
# against the particles of its +-1 cells, the same for both layouts of one
# state; the candidates a kernel's own blocking visits beyond them are
# printed beside the bound and are not part of it):
#   every real pair: r² (dim sub, dim mul, dim - 1 add);
#   a pair beyond h (r² >= h²): one compare more, since its term is exactly
#     +-0 (tests/test_torch_skip.py);
#   a pair within h, K1 and K3: h² - r², max, q³ (2 mul), accumulate (5);
#     K2 and K4: max + sqrt + divide, r²·inv_r, h -, max, c_s·t·t·inv_r (3),
#     p_i + p_j, coef_p (3), coef_v (3) (16), and per component sub, 2 mul,
#     2 add (5 dim).
# Once per particle, not per pair: K2's and K4's 1/max(rho_j, 1e-12) (max
# + divide).  The bf16 K1/K2 add one frame offset per coordinate once per
# real slot a staged block stages (`staged_slots`); the upcast is a shift.


def ops_needed(name: str, dim: int, counts: dict, staged: int = 0) -> int:
    """fp32 operations of kernel `name` on inputs with `counts` (see
    `pair_counts`) and, for the bf16 kernels, `staged` staged real slots."""
    r2 = 3 * dim - 1
    far = counts["real"] - counts["near"]
    if "density" in name:
        n = counts["near"] * (r2 + 5)
    else:
        n = counts["near"] * (r2 + 16 + 5 * dim) + 2 * counts["particles"]
    n += far * (r2 + 1)
    if name.endswith("_bf16"):
        n += dim * staged
    return n


REPLACES = {
    "slot_density": "sph_tpu/pallas_step.py:750 (_density_kernel)",
    "slot_force": "sph_tpu/pallas_step.py:837 (_force_kernel)",
    "packed_density": "sph_tpu/pallas_step.py:969 (_density_kernel_packed)",
    "packed_force": "sph_tpu/pallas_step.py:1024 (_force_kernel_packed)",
    "stage_transpose": "sph_tpu/pallas_step.py:555 (_stage_transpose_kernel)",
    "slot_density_bf16": "sph_tpu/pallas_step.py:750 (_density_kernel, bf16 "
                         "branch :767-790)",
    "slot_force_bf16": "sph_tpu/pallas_step.py:837 (_force_kernel, bf16 "
                       "branch :855-887)",
    "probe_fp32": "bench/probe_vpu_bf16.py:38 (make_kernel, float32)",
    "probe_bf16": "bench/probe_vpu_bf16.py:38 (make_kernel, bfloat16)",
}
SOURCE = {
    "slot_density": "sph_tpu_torch/csrc/slot_kernels.cu",
    "slot_force": "sph_tpu_torch/csrc/slot_kernels.cu",
    "packed_density": "sph_tpu_torch/csrc/packed_kernels.cu",
    "packed_force": "sph_tpu_torch/csrc/packed_kernels.cu",
    "stage_transpose": "sph_tpu_torch/csrc/stage_kernels.cu",
    "slot_density_bf16": "sph_tpu_torch/csrc/slot_kernels.cu",
    "slot_force_bf16": "sph_tpu_torch/csrc/slot_kernels.cu",
    "probe_fp32": "sph_tpu_torch/csrc/probe_kernels.cu",
    "probe_bf16": "sph_tpu_torch/csrc/probe_kernels.cu",
}
# the production default (`sph-tpu run`'s --method auto)
RESIDENT = dict(sort_every=4, slot_resident=True)
RHO_RTOL, RHO_ATOL, F_REL = 1e-5, 1e-6, 3e-5
# bf16 against fp32 per particle (tests/test_bf16.py:50-54)
BF16_RHO_RTOL, BF16_F_REL = 2e-2, 6e-2
N_TIMED = 20
# steps each path is driven for
DEPTH = {"dam3d_100k": 200, "splash3d_1m": 20, "emitters3d@settled": 200}
SETTLED = Path(__file__).resolve().parent / "bench" / ".settled_emitters3d_full.npz"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = N_TIMED, warm: int = 3) -> float:
    """Mean device time of fn() over n launches (CUDA events), after warm-up."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int = N_TIMED) -> float:
    """Device time per call of fn(): n calls captured in one CUDA graph,
    its replay timed with CUDA events, so no host work sits between the
    launches (a launch from Python costs ~30-40 us of host time, more than
    some of these kernels take)."""
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


def in_turns(new, simple, rounds: int = 3) -> dict:
    """Times of a staged kernel and its simple yardstick, taken in turns
    (simple, new, new, simple) `rounds` times by two methods: `ms` and
    `simple_ms` launch from the host and time with CUDA events, as
    `cuda_ms` times every other kernel; `graph_ms` and `simple_graph_ms`
    replay the launches as a CUDA graph (`graph_ms`).  Medians of each, the
    ratio of the two kernels by each method, and every turn."""
    turns = {"ms": [], "simple_ms": [], "graph_ms": [], "simple_graph_ms": []}
    for _ in range(rounds):
        for timer, key in ((cuda_ms, "ms"), (graph_ms, "graph_ms")):
            for fn, pre in ((simple, "simple_"), (new, ""), (new, ""),
                            (simple, "simple_")):
                turns[pre + key].append(timer(fn))
    med = {k: statistics.median(v) for k, v in turns.items()}
    return {**med, "simple_over_new": med["simple_ms"] / med["ms"],
            "simple_over_new_graph": med["simple_graph_ms"] / med["graph_ms"],
            "turns": turns}


def bitwise(a, b) -> bool:
    """Equal bit for bit (+0 and -0 apart)."""
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def hold_to_simple(where: str, feat, rp, f, args) -> None:
    """The staged K1/K2 outputs `rp`, `f` bitwise their simple yardsticks'
    on the same inputs (K2 of both on `rp`)."""
    from sph_tpu_torch import slot_kernels as sk

    rp_s = sk.slot_density_simple(feat, *args)
    f_s = sk.slot_force_simple(feat, rp, *args)
    torch.cuda.synchronize()
    check(bitwise(rp, rp_s), f"K1 bitwise its yardstick at {where}")
    check(bitwise(f, f_s), f"K2 bitwise its yardstick at {where}")


def live_histogram(addr) -> dict:
    """Live i-slots (real particles) per live 128-lane group of the occupied
    rows: the work a staged block has for its threads, and the share of the
    lanes of the warps they fill that hold one."""
    n = int(addr.n_occ[0])
    gc = addr.gcounts[1 : n + 1, 0, 1:-1].reshape(-1)
    gc = gc[gc > 0].long()
    edges = (1, 9, 17, 33, 49, 65, 97, 129)
    hist = {f"{a}-{b - 1}": int(((gc >= a) & (gc < b)).sum())
            for a, b in zip(edges[:-1], edges[1:])}
    live = int(gc.sum())
    return {"live_groups": int(gc.numel()), "live_slots": live,
            "mean": live / max(int(gc.numel()), 1),
            "median": float(gc.float().median()) if gc.numel() else 0.0,
            "hist": hist,
            "lanes_used_by_full_warps": live / max(
                int(((gc + 31) // 32 * 32).sum()), 1)}


def slot_kernel_name(mangled: str) -> str | None:
    """A slot kernel (K1/K2, staged and simple, by dim and feature type)
    by its mangled name."""
    k = re.search(r"(density_kernel_simple|force_kernel_simple|"
                  r"staged_kernel)ILi(\d)E([tf])(?:Lb([01])E)?", mangled)
    if not k:
        return None
    kind = {"0": ", K1", "1": ", K2", None: ""}[k.group(4)]
    feat = "bf16" if k.group(3) == "t" else "float"
    return f"{k.group(1)}<{k.group(2)}, {feat}{kind}>"


def packed_kernel_name(mangled: str) -> str | None:
    """A packed-row kernel (K3/K4, warp and simple) with its template
    arguments (dim; tile, band, prefetch) by its mangled name."""
    k = re.search(r"((?:simple|warp)_(?:density|force)_kernel)I"
                  r"((?:L[ib]\d+E)+)E", mangled)
    if not k:
        return None
    return f"{k.group(1)}<{', '.join(re.findall(r'L[ib](\d+)E', k.group(2)))}>"


def ptxas_summary(log: str, kernel_name=slot_kernel_name) -> dict:
    """Per kernel (named by `kernel_name`) its registers, spill bytes and
    static shared memory, from nvcc's -Xptxas -v lines."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\S+?)'?(?: for|$)", line.strip())
        if m:
            name = kernel_name(m.group(1))
            if name:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(m.group(1)),
                             static_smem=int(sm.group(1)) if sm else 0)
    return out


def phase_build():
    from sph_tpu_torch import _build

    t0 = time.perf_counter()
    all_built = _build.build_all(force=True)
    wall = time.perf_counter() - t0
    for name, built in all_built.items():
        ptxas = [ln.strip() for ln in built.log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        emit({"phase": "build", "library": built.path.name,
              "seconds": built.seconds, "wall_seconds_all": wall,
              "ptxas": ptxas})
    lib = all_built["slot_kernels"].lib
    src = (Path(__file__).resolve().parent / SOURCE["slot_density"]).read_text()
    emit({"phase": "build", "library": "slot_kernels", "kernels":
          ptxas_summary(all_built["slot_kernels"].log),
          "staged_block_threads": int(re.search(
              r"constexpr int kThreads = (\d+);", src).group(1)),
          "staged_dynamic_smem_bytes": {
              f"{kind} cap {cap} xm {xm}": lib.slot_stage_bytes(force, cap, xm)
              for kind, force in (("K1", 0), ("K2", 1))
              for cap, xm in ((16, 1), (8, 2))}})
    from sph_tpu_torch import packed_kernels as pk

    emit({"phase": "build", "library": "packed_kernels", "kernels":
          ptxas_summary(all_built["packed_kernels"].log, packed_kernel_name),
          "warp_kernel_defaults": pk.default_choices()})


def reuse_grid(scene, sort_every: int, xsub: int = 1):
    """The skinned lattice run(..., sort_every=) builds its addressing on."""
    from sph_tpu_torch import default_skin, neighbors

    base = neighbors.GridSpec.for_scene(scene)
    return neighbors.GridSpec.for_scene(
        scene, cap=base.cap, skin=default_skin(scene, sort_every), xsub=xsub)


def slot_inputs(scene, state, packed: bool = False, grid=None):
    """(sg, addr, feat) of `state` on `grid` (default: the per-step lattice
    of `scene`)."""
    from sph_tpu_torch import neighbors, pallas_step as ps

    if grid is None:
        grid = neighbors.GridSpec.for_scene(scene)
    sg = ps.packed_grid(grid) if packed else ps.slot_grid(grid)
    addr = ps.build_addr(state.x, state.active, grid, sg)
    feat = ps.scatter_slots(addr, ps._pack_rows6(state.x, state.v), sg)
    return sg, addr, feat


def pair_counts(feat, addr, sg, params) -> dict:
    """The work the function needs on these (fp32, xsub=1) inputs: `real`
    candidate pairs of real particles (each live i-slot against the real
    j-slots of its window), `near` those of them within h (r² < h²), and
    the live i-slots (`particles`)."""
    from sph_tpu_torch import slot_kernels as sk

    h2 = params.h * params.h
    real = near = particles = 0
    for row, lane, nr, j in sk._chunks(feat, addr.n_occ, addr.nbr_pos,
                                       addr.gcounts, sg.cap):
        ok = sk._take(feat, nr, j, 0) < 1e17
        r2 = 0.0
        for c in range(params.dim):
            dc = feat[row, c, lane].float()[:, None] - sk._take(feat, nr, j, c)
            r2 = r2 + dc * dc
        real += int(ok.sum())
        near += int((ok & (r2 < h2)).sum())
        particles += int(row.numel())
    return {"real": real, "near": near, "particles": particles}


def staged_slots(feat, addr, sg) -> int:
    """Real slots the staged K1/K2 stage: for each live 128-lane group g of
    an occupied row, those of lanes [g·128 - xm·cap, (g+1)·128 + xm·cap) in
    each of its neighbor rows (a bf16 kernel widens and offsets each once)."""
    lanes = feat.shape[2]
    real = (feat[:, 0, :].float() < 1e17).int().cumsum(dim=1)
    pc = torch.nn.functional.pad(real, (1, 0))              # [c_rows, lanes+1]
    n = int(addr.n_occ[0])
    rows, g = torch.nonzero(addr.gcounts[1 : n + 1, 0, 1:-1] > 0,
                            as_tuple=True)
    rows, g = rows + 1, g + 1                               # interior groups
    m = sg.xsub * sg.cap
    lo = (g * 128 - m).clamp(0, lanes)
    hi = ((g + 1) * 128 + m).clamp(0, lanes)
    nr = addr.nbr_pos[:, rows].long()                       # [R, live groups]
    return int((pc[nr, hi] - pc[nr, lo]).sum())


def packed_pairs(addr) -> tuple[int, int]:
    """(pairs K3/K4's blocking visits: each particle of a row against every
    particle of its R neighbor rows, most of them beyond h and so no part
    of the bound; the most candidates any one particle has, i.e. the
    longest loop of a thread)."""
    cnt = addr.gcounts[:, 0, :].sum(dim=1).long()         # [c_rows], cnt[0] = 0
    loop = cnt[addr.nbr_pos.long()].sum(dim=0)            # [c_rows]
    return int((cnt * loop).sum()), int(loop[cnt > 0].max())


def bound(name: str, feat, addr, sg, dim: int, counts: dict,
          staged: int = 0):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations (`ops_needed` on `counts`, the work of the per-step lattice)
    over the fp32 rate, from this run's inputs.  Slot layout:
    only the occupied rows 1..n_occ are read and written (the gathers read
    no other row, so the zeros the kernels write past n_occ are not
    counted).  Packed rows: only the occupied 128-lane blocks.  Features
    count at their size (bf16: 2 B), rho, p and f at 4 B."""
    if sg.packed:
        n_lanes = int((addr.gcounts > 0).sum()) * 128
    else:
        n_lanes = int(addr.n_occ[0]) * feat.shape[2]
    fb = feat.element_size()
    if "density" in name:         # read x, write rho and p
        moved = n_lanes * (dim * fb + 2 * 4)
    else:                         # read x, v, rho and p, write f
        moved = n_lanes * (2 * dim * fb + 2 * 4 + dim * 4)
    t_bytes = moved / PEAK_BYTES_S * 1e3
    t_ops = ops_needed(name, dim, counts, staged) / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(preset_name: str, dev, state=None, grid=None,
                  lattice: str = "per step"):
    """K1 and K2 against their plain versions and bitwise their simple
    yardsticks on the slot arrays of `state` (default: the preset's step 0)
    built on `grid` (default: the per-step lattice)."""
    from sph_tpu_torch import init, pallas_step as ps, preset
    from sph_tpu_torch import slot_kernels as sk

    scene = preset(preset_name.split("@")[0])
    params = scene.params
    if state is None:
        state = init(scene, device=dev)
    sg, addr, feat = slot_inputs(scene, state, grid=grid)
    args = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params)
    where = f"{preset_name}, lattice {lattice}"

    rp_k = sk.slot_density(feat, *args)
    rp_p = sk.density_plain(feat, *args)
    torch.cuda.synchronize()
    rho_k, ok = ps._gather_rho(rp_k, addr, sg, params)
    rho_p, _ = ps._gather_rho(rp_p, addr, sg, params)
    check(bool(torch.allclose(rho_k, rho_p, rtol=RHO_RTOL, atol=RHO_ATOL)),
          f"K1 vs plain at {where}")
    f_k = sk.slot_force(feat, rp_k, *args)
    f_p = sk.force_plain(feat, rp_k, *args)
    torch.cuda.synchronize()
    d = params.dim
    fk = ps._gather_f(f_k, addr, sg, d, ok)
    fp = ps._gather_f(f_p, addr, sg, d, ok)
    f_err = float(torch.max(torch.abs(fk - fp)))
    f_scale = float(torch.max(torch.abs(fp)))
    check(f_err / f_scale < F_REL, f"K2 vs plain at {where}")
    check(bool(torch.isfinite(rho_k).all() and torch.isfinite(fk).all()),
          f"finite kernel outputs at {where}")
    hold_to_simple(where, feat, rp_k, f_k, args)

    # the pairs the function needs are those of the per-step lattice
    sg1, addr1, feat1 = (slot_inputs(scene, state) if grid is not None
                         else (sg, addr, feat))
    counts = pair_counts(feat1, addr1, sg1, params)
    res = {}
    for name, kern, simple, plain, err in (
        ("slot_density", lambda: sk.slot_density(feat, *args),
         lambda: sk.slot_density_simple(feat, *args),
         lambda: sk.density_plain(feat, *args),
         float(torch.max(torch.abs(rho_k - rho_p)))),
        ("slot_force", lambda: sk.slot_force(feat, rp_k, *args),
         lambda: sk.slot_force_simple(feat, rp_k, *args),
         lambda: sk.force_plain(feat, rp_k, *args), f_err),
    ):
        b_ms, b_by = bound(name, feat, addr, sg, d, counts)
        res[name] = {"max_abs_err": err, "bitwise_simple": True,
                     **in_turns(kern, simple), "plain_ms": cuda_ms(plain),
                     "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernels", "preset": preset_name, "lattice": lattice,
          "feat": list(feat.shape), "n_groups": sg.n_groups,
          "n_occ": int(addr.n_occ[0]), "particles": int(ok.sum()),
          "pairs": counts, "f_max_rel_err": f_err / f_scale,
          "live_per_group": live_histogram(addr), "kernels": res})
    return res


def tiny_launch_ms(dev) -> float:
    """Time per launch of the smallest kernel PyTorch makes (a one-element
    in-place add), back to back: the floor any launch pays."""
    t = torch.zeros(1, device=dev)
    return cuda_ms(lambda: t.add_(1.0), n=200)


def hold_packed_to_simple(where: str, feat, rp, f, args) -> None:
    """The warp K3/K4 outputs `rp`, `f` bitwise their simple yardsticks'
    on the same inputs (K4 of both on `rp`)."""
    from sph_tpu_torch import packed_kernels as pk

    rp_s = pk.packed_density_simple(feat, *args)
    f_s = pk.packed_force_simple(feat, rp, *args)
    torch.cuda.synchronize()
    check(bitwise(rp, rp_s), f"K3 bitwise its yardstick at {where}")
    check(bitwise(f, f_s), f"K4 bitwise its yardstick at {where}")


# the launch choices of the warp K3/K4 measured against each other
SWEEP_WARPS, SWEEP_TILES = (2, 4, 8), (32, 64, 128)


def sweep_packed(where: str, feat, rp, f, args, rounds: int = 3) -> dict:
    """Every launch choice of the warp K3/K4 (warps a block, tile, prefetch,
    band), each held bitwise to the default kernels' `rp` and `f`, then
    timed by CUDA-graph replay `rounds` times in turns, all choices in each
    round: the median per choice, the fastest, and the defaults' time (the
    choice the path runs)."""
    from sph_tpu_torch import packed_kernels as pk

    def key(kern, warps, tile, prefetch, band):
        return f"{kern} w{warps} t{tile} p{int(prefetch)} b{int(band)}"

    runs = {}
    for warps in SWEEP_WARPS:
        for tile in SWEEP_TILES:
            for prefetch in (False, True):
                for band in (False, True):
                    choice = dict(warps=warps, tile=tile, prefetch=prefetch,
                                  band=band)
                    runs[key("K3", **choice)] = functools.partial(
                        pk.packed_density_variant, feat, *args, **choice)
                    runs[key("K4", **choice)] = functools.partial(
                        pk.packed_force_variant, feat, rp, *args, **choice)
    for name, fn in runs.items():
        out = fn()
        torch.cuda.synchronize()
        check(bitwise(out, rp if name.startswith("K3") else f),
              f"{name} bitwise the default at {where}")
    turns = {name: [] for name in runs}
    for _ in range(rounds):
        for name, fn in runs.items():
            turns[name].append(graph_ms(fn))
    med = {name: statistics.median(v) for name, v in turns.items()}
    d = pk.default_choices()
    default = {"K3": key("K3", **d["density"]), "K4": key("K4", **d["force"])}
    best = {k: min((n for n in med if n.startswith(k)), key=med.get)
            for k in ("K3", "K4")}
    return {"graph_ms": med, "defaults": default, "fastest": best,
            "default_over_fastest": {k: med[default[k]] / med[best[k]]
                                     for k in ("K3", "K4")}}


def phase_kernels_packed(dev, state, scene, grid=None, lattice="per step"):
    """K3 and K4 against their plain versions per particle and bitwise
    their simple yardsticks, on the packed arrays of the settled emitters3d
    state built on `grid` (default: the per-step lattice); times of the two
    designs in turns, the bound, and the sweep of the launch choices."""
    from sph_tpu_torch import neighbors, packed_kernels as pk
    from sph_tpu_torch import pallas_step as ps

    params, d = scene.params, scene.params.dim
    if grid is None:
        grid = neighbors.GridSpec.for_scene(scene)
    sg, addr, feat = slot_inputs(scene, state, packed=True, grid=grid)
    jb = ps._jblocks(addr, sg)
    args = (addr.n_occ, addr.nbr_pos, jb, addr.gcounts, params)
    where = f"emitters3d@settled, lattice {lattice}"

    rp_k = pk.packed_density(feat, *args)
    rp_p = pk.packed_density_plain(feat, *args)
    torch.cuda.synchronize()
    rho_k, ok = ps._gather_rho(rp_k, addr, sg, params)
    rho_p, _ = ps._gather_rho(rp_p, addr, sg, params)
    check(bool(torch.allclose(rho_k, rho_p, rtol=RHO_RTOL, atol=RHO_ATOL)),
          f"K3 vs plain at {where}")
    f_k = pk.packed_force(feat, rp_k, *args)
    f_p = pk.packed_force_plain(feat, rp_k, *args)
    torch.cuda.synchronize()
    fk = ps._gather_f(f_k, addr, sg, d, ok)
    fp = ps._gather_f(f_p, addr, sg, d, ok)
    f_err = float(torch.max(torch.abs(fk - fp)))
    f_scale = float(torch.max(torch.abs(fp)))
    check(f_err / f_scale < F_REL, f"K4 vs plain at {where}")
    check(bool(torch.isfinite(rho_k).all() and torch.isfinite(fk).all()),
          "finite packed kernel outputs")
    check(int(ok.sum()) == int(state.n_active()) and int(addr.overflow) == 0,
          "every active particle has a packed lane")
    hold_packed_to_simple(where, feat, rp_k, f_k, args)

    visited, longest = packed_pairs(addr)
    sg_s, addr_s, feat_s = slot_inputs(scene, state)
    counts = pair_counts(feat_s, addr_s, sg_s, params)
    res = {}
    for name, kern, simple, plain, err in (
        ("packed_density", lambda: pk.packed_density(feat, *args),
         lambda: pk.packed_density_simple(feat, *args),
         lambda: pk.packed_density_plain(feat, *args),
         float(torch.max(torch.abs(rho_k - rho_p)))),
        ("packed_force", lambda: pk.packed_force(feat, rp_k, *args),
         lambda: pk.packed_force_simple(feat, rp_k, *args),
         lambda: pk.packed_force_plain(feat, rp_k, *args), f_err),
    ):
        b_ms, b_by = bound(name, feat, addr, sg, d, counts)
        res[name] = {
            "max_abs_err": err, "bitwise_simple": True,
            **in_turns(kern, simple), "plain_ms": cuda_ms(plain, n=5, warm=1),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        res[name]["over_bound"] = res[name]["ms"] / b_ms
        res[name]["graph_over_bound"] = res[name]["graph_ms"] / b_ms
    n_occ = int(addr.n_occ[0])
    units = addr.gcounts[1 : n_occ + 1, 0, :].long()
    live_units = int(((units + 31) // 32).sum())
    emit({"phase": "kernels", "preset": "emitters3d@settled", "layout": "packed",
          "lattice": lattice, "grid": list(grid.shape), "cell": grid.cell,
          "c_rows": sg.c_rows, "lanes": sg.lanes, "n_groups": sg.n_groups,
          "n_occ": n_occ, "particles": int(ok.sum()),
          "jb_max": int(jb.max()), "rows_over_128": int((jb >= 2).sum()),
          "occupied_blocks": int((addr.gcounts > 0).sum()),
          "warp_units": sg.c_rows * sg.lanes // 32, "live_warp_units": live_units,
          "lanes_used_by_live_units": int(ok.sum()) / max(32 * live_units, 1),
          "pairs": counts, "pairs_visited_in_whole_rows": visited,
          "most_candidates_of_a_particle": longest,
          "f_max_rel_err": f_err / f_scale,
          "tiny_launch_ms": tiny_launch_ms(dev), "kernels": res})
    emit({"phase": "sweep", "preset": "emitters3d@settled", "lattice": lattice,
          **sweep_packed(where, feat, rp_k, f_k, args)})
    return res


@contextlib.contextmanager
def audited_advances():
    """The audited advances `run` makes while the block runs (observation
    only: they carry the resident policies' counters and mode)."""
    from sph_tpu_torch import step as step_mod

    made = []
    real = step_mod.make_audited_advance

    def spy(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    step_mod.make_audited_advance = spy
    try:
        yield made
    finally:
        step_mod.make_audited_advance = real


def reset_counts() -> None:
    from sph_tpu_torch import packed_kernels as pk, slot_kernels as sk
    from sph_tpu_torch import probe_vpu_bf16 as pr
    from sph_tpu_torch import stage_kernels as st, step as step_mod

    sk.reset_launches()
    pk.reset_launches()
    st.reset_launches()
    pr.reset_launches()
    step_mod.reset_fetches()


def read_counts(name: str) -> dict:
    """The launch counts of the path `name` just drove; no path may launch
    a yardstick (`*_simple`) or a measured launch choice (`*_variant`)."""
    from sph_tpu_torch import packed_kernels as pk, slot_kernels as sk
    from sph_tpu_torch import probe_vpu_bf16 as pr
    from sph_tpu_torch import stage_kernels as st

    counts = {**sk.LAUNCHES, **pk.LAUNCHES, **st.LAUNCHES, **pr.LAUNCHES}
    check(not any(n for k, n in counts.items()
                  if "simple" in k or "variant" in k),
          f"no yardstick or variant kernel launched at {name}")
    return counts


def health(state, scene) -> dict:
    """What the paths' health checks read off the state a run ends on."""
    act = state.active
    fluid = act & (state.kind == 0)
    return {
        "finite": all(bool(torch.isfinite(getattr(state, f)).all())
                      for f in ("x", "v", "acc", "rho", "p")),
        "particles": int(act.sum()),
        "rho_mean_over_rest":
            float(state.rho[fluid].mean()) / scene.params.rest_density,
        "max_speed": float(torch.linalg.vector_norm(state.v[act], dim=1).max()),
    }


def check_health(name: str, hl: dict, n_start: int, overflow: int,
                 rho_band=None, vmax_limit: float = 500.0) -> None:
    check(hl["finite"], f"finite state at {name}")
    check(overflow == 0, f"no cap overflow at {name}")
    if rho_band is not None:
        check(rho_band[0] <= hl["rho_mean_over_rest"] <= rho_band[1],
              f"mean rho/rho0 at {name}")
    check(hl["max_speed"] < vmax_limit, f"max|v| < {vmax_limit} at {name}")
    check(hl["particles"] >= n_start, f"no particle lost at {name}")


def phase_path(name: str, scene, state, n_steps: int, dev, run_kw=None,
               want=None, rho_band=None, vmax_limit: float = 500.0):
    """One of the port's paths through `run`, with its health checks.
    `want` maps each kernel to the launches the path must make: a number,
    or a predicate for a path whose plan depends on its audit.  For the
    resident paths the output carries the policy's counters, its mode and
    the host fetches per block."""
    from sph_tpu_torch import neighbors, pallas_step as ps, run
    from sph_tpu_torch import step as step_mod

    run_kw = dict(run_kw or {})
    sort_every = run_kw.get("sort_every", 1)
    packed = bool(run_kw.get("packed_rows"))
    xsub = run_kw.get("xsub", 1)
    # the audit lattice is the one the path builds its addressing on
    if sort_every > 1:
        grid = reuse_grid(scene, sort_every, xsub)
    else:
        grid = neighbors.GridSpec.for_scene(scene, xsub=xsub)
    sg = ps.packed_grid(grid) if packed else ps.slot_grid(grid)
    seen = {"overflow": 0, "n_occ": 0}

    def audit(st):  # build-time cap overflow of the state a dispatch ends on
        addr = ps.build_addr(st.x, st.active, grid, sg)
        seen["overflow"] = max(seen["overflow"], int(addr.overflow))
        seen["n_occ"] = int(addr.n_occ[0])

    audit(state)
    n_start = int(state.n_active())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    notes = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(notes), audited_advances() as made:
        state = run(scene, n_steps, method="pallas", state=state, device=dev,
                    **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(name)
    fetches = dict(step_mod.FETCHES)
    peak = torch.cuda.max_memory_allocated()
    audit(state)
    sys.stderr.write(notes.getvalue())

    hl = health(state, scene)
    out = {"phase": "path", "preset": name, "steps": n_steps,
           "run": {k: v for k, v in run_kw.items()},
           **hl, "particles_at_start": n_start,
           "ms_per_step": wall / n_steps * 1e3,
           "ms_per_step_note": "host clock over run(), prime included",
           "peak_bytes": peak, "launches": launches,
           "overflow": seen["overflow"], "n_occ": seen["n_occ"],
           "audit_notes": notes.getvalue().strip().splitlines(),
           "final_step": int(state.step)}
    if run_kw.get("slot_resident"):
        out["policy"] = {
            "healed": sum(getattr(a, "healed", 0) for a in made),
            "repaired": sum(getattr(a, "repaired", 0) for a in made),
            "rebuilds": sum(getattr(a, "rebuilds", 0) for a in made),
            "modes": [a.mode for a in made if hasattr(a, "mode")],
            "repair_k": step_mod.default_repair_k(
                scene, auto=True, xsub=xsub,
                row_pair=bool(run_kw.get("row_pair")),
                packed_rows=bool(run_kw.get("packed_rows")))
            if run_kw.get("repair_k", None) is None else run_kw["repair_k"],
        }
        out["host_fetches"] = {
            **fetches,
            "per_block": fetches["fetches"] / max(fetches["blocks"], 1)}
    emit(out)
    check_health(name, hl, n_start, seen["overflow"], rho_band, vmax_limit)
    for kernel, n in (want or {}).items():
        good = n(launches[kernel]) if callable(n) else launches[kernel] == n
        check(good, f"{kernel} launched {launches[kernel]} times at {name}")
    out["state"] = state
    return out


def phase_agreement(dev, state, scene, n_steps: int = 20):
    """Packed rows against the slot layout from the same state, per step:
    positions, and the host clock over each run."""
    from sph_tpu_torch import run

    def timed(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(scene, n_steps, method="pallas", state=state, device=dev, **kw)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / n_steps * 1e3

    # in turns, so that neither layout has the warmer host
    a, ms_packed = timed(packed_rows=True)
    b, ms_slot = timed()
    _, ms_slot2 = timed()
    _, ms_packed2 = timed(packed_rows=True)
    act = a.active
    same_active = bool(torch.equal(act, b.active))
    dx = float((a.x[act] - b.x[act]).abs().max())
    emit({"phase": "agreement", "preset": "emitters3d@settled",
          "steps": n_steps, "max_abs_dx": dx, "limit": 1e-3 * scene.params.h,
          "same_active": same_active,
          "ms_per_step_packed": [ms_packed, ms_packed2],
          "ms_per_step_slot": [ms_slot, ms_slot2]})
    check(same_active, "packed and slot runs activate the same particles")
    check(dx < 1e-3 * scene.params.h, "packed vs slot x within 1e-3 h")


def phase_determinism(dev, settled, scene_e, first_packed):
    from sph_tpu_torch import init, preset, run

    scene = preset("dam3d_100k")
    s0 = init(scene, device=dev)
    a = run(scene, 20, method="pallas", state=s0, device=dev)
    b = run(scene, 20, method="pallas", state=s0, device=dev)
    same = bool(torch.equal(a.x, b.x))
    emit({"phase": "determinism", "preset": "dam3d_100k", "steps": 20,
          "bitwise_equal_x": same})
    check(same, "two runs from one init give bitwise-equal x")
    # the packed run of the path phase, once more
    n_steps = DEPTH["emitters3d@settled"]
    again = run(scene_e, n_steps, method="pallas", state=settled,
                packed_rows=True, device=dev)
    same = bool(torch.equal(again.x, first_packed.x))
    emit({"phase": "determinism", "preset": "emitters3d@settled",
          "steps": n_steps, "packed_rows": True, "bitwise_equal_x": same})
    check(same, "two packed runs from the checkpoint give bitwise-equal x")


def _under_sync_debug(fn, dev):
    """fn() under torch's sync debug mode "error", which raises at any call
    that synchronizes the host with the card (a blocking copy, .item(),
    nonzero); also shows that the mode catches such a copy."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
        try:  # the mode must catch the kind of copy the steps no longer make
            torch.tensor((1.0,), device=dev)
            caught = False
        except RuntimeError:
            caught = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(caught, "sync debug mode catches a blocking host-to-device copy")
    return out


def phase_no_sync(dev, settled, scene_e):
    """Steps enqueue their work without waiting on the host.  One dispatch
    before the checked one makes the cached device constants."""
    from sph_tpu_torch import init, make_advance, preset, prime

    scene = preset("dam3d_100k")
    advance = make_advance(scene, "pallas", steps_per_dispatch=2, device=dev)
    state = prime(scene, init(scene, device=dev), "pallas", device=dev)
    state = _under_sync_debug(lambda: advance(advance(state)), dev)
    check(bool(torch.isfinite(state.x).all()), "finite state after no-sync steps")
    emit({"phase": "no_sync", "preset": "dam3d_100k", "steps": 2,
          "sync_debug_mode": "error", "host_syncs": 0})
    # one 4-step address-reuse block on packed rows: the violation count
    # stays on the device until the caller fetches it
    reuse = make_advance(scene_e, "pallas", steps_per_dispatch=4,
                         sort_every=4, packed_rows=True, device=dev)
    warm, _ = reuse(settled)
    state, viol = _under_sync_debug(lambda: reuse(warm), dev)
    check(bool(torch.isfinite(state.x).all()),
          "finite state after a no-sync reuse block")
    emit({"phase": "no_sync", "preset": "emitters3d@settled", "steps": 4,
          "sort_every": 4, "packed_rows": True, "sync_debug_mode": "error",
          "host_syncs": 0, "violations": int(viol)})


def phase_profile(name: str, scene, state, n_steps: int, dev,
                  sort_every: int = 1, **step_kw):
    """Where a step's device time goes (informational: no check).  With
    `sort_every` > 1 the profiled work is one address-reuse dispatch of
    `n_steps` steps (`make_advance(sort_every=)`), the violation count
    fetched once at its end as the audited advance does."""
    from torch.profiler import ProfilerActivity, profile

    from sph_tpu_torch import make_advance, make_step, run

    if sort_every > 1:
        reuse = make_advance(scene, "pallas", steps_per_dispatch=n_steps,
                             sort_every=sort_every, device=dev, **step_kw)

        def drive(st):
            st, viol = reuse(st)
            return st, int(viol)

        state, _ = drive(state)     # warm: the cached device constants
    else:
        state = run(scene, 2, method="pallas", state=state, device=dev,
                    **step_kw)
        step = make_step(scene, "pallas", device=dev, **step_kw)

        def drive(st):
            for _ in range(n_steps):
                st = step(st)
            return st, 0

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, viol = drive(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []  # device-side events only (kernels, memcpy, memset)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.device_time_total / 1e3 / n_steps,
                         e.count / n_steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    emit({"phase": "profile", "preset": name, "steps": n_steps,
          "step": step_kw, "sort_every": sort_every, "violations": viol,
          "wall_ms_per_step_profiled": wall / n_steps * 1e3,
          "device_ms_per_step": busy,
          "device_busy_share": busy / (wall / n_steps * 1e3),
          "device_ops_per_step": sum(r[1] for r in rows),
          "top": [{"ms_per_step": ms, "per_step": c, "name": k[:90]}
                  for ms, c, k in rows[:12]]})


def phase_stage(preset_name: str, dev):
    """K5 on the step-0 slot addressing of a preset, with the resident
    path's 7 scatter columns (x | v | movable): against its plain version
    and scatter_slots(staged=True) against the direct scatter, both
    bitwise, with CUDA-event times and the bound; then the path of K5's
    entry point, scatter_slots(staged=True), once, counted."""
    from sph_tpu_torch import init, pallas_step as ps, preset
    from sph_tpu_torch import stage_kernels as st

    scene = preset(preset_name)
    state = init(scene, device=dev)
    sg, addr, _ = slot_inputs(scene, state)
    d = scene.params.dim
    zpad = state.x.new_zeros((state.capacity, 3 - d))
    movf = (state.active & (state.kind == 0))[:, None].float()
    rows = torch.cat([state.x, zpad, state.v, zpad, movf], dim=1)

    reset_counts()                      # the entry point's own path
    staged = ps.scatter_slots(addr, rows, sg, staged=True)
    torch.cuda.synchronize()
    launches = read_counts(f"scatter_slots(staged=True) at {preset_name}")
    check(launches["stage_transpose"] == 1,
          f"scatter_slots(staged=True) launched K5 once at {preset_name}")

    direct = ps.scatter_slots(addr, rows, sg)
    stag = ps.stage_rows(addr, rows, sg)
    c_rows, lanes = sg.c_rows, sg.lanes
    out_k = st.stage_transpose(stag, c_rows, lanes)
    out_p = st.stage_transpose_plain(stag, c_rows, lanes)
    torch.cuda.synchronize()
    check(bool(torch.equal(out_k, out_p)), f"K5 == plain at {preset_name}")
    check(bool(torch.equal(staged, direct)),
          f"staged scatter == direct scatter at {preset_name}")
    lib_out = torch.empty_like(out_p)

    def library():  # one PyTorch call: a strided copy into the output
        lib_out.copy_(stag.view(c_rows, lanes, 8).transpose(1, 2))

    moved = 2 * stag.numel() * stag.element_size()   # read once, write once
    res = {
        "max_abs_err": float((out_k - out_p).abs().max()),
        "ms": cuda_ms(lambda: st.stage_transpose(stag, c_rows, lanes)),
        "plain_ms": cuda_ms(lambda: st.stage_transpose_plain(
            stag, c_rows, lanes)),
        "bound_ms": moved / PEAK_BYTES_S * 1e3, "bound_by": "bytes",
        "library_ms": cuda_ms(library),
    }
    emit({"phase": "kernels", "preset": preset_name, "kernel": "K5",
          "stag": list(stag.shape), "feat": list(out_k.shape),
          "bytes_moved": moved,
          "staged_scatter_ms": cuda_ms(
              lambda: ps.scatter_slots(addr, rows, sg, staged=True)),
          "direct_scatter_ms": cuda_ms(lambda: ps.scatter_slots(addr, rows, sg)),
          "kernels": {"stage_transpose": res}})
    emit({"phase": "path", "preset": preset_name,
          "entry": "scatter_slots(staged=True)", "launches": launches})
    return res, launches["stage_transpose"]


def resident_launches(out, steps: int, primes: int) -> int:
    """K1/K2 launches the slot-layout resident path must make: one a step,
    one a prime, and 4 more per healed block (its exact per-step re-run);
    rebuilds, repairs and demoted dispatches add none of their own."""
    return steps + primes + 4 * out["policy"]["healed"]


def phase_resident_agreement(dev, n_steps: int = 20):
    """resident4auto against the non-resident reuse path at dam3d_100k,
    repair off: x within 1e-3 h; and two resident runs bitwise equal."""
    from sph_tpu_torch import init, preset, run

    scene = preset("dam3d_100k")
    s0 = init(scene, device=dev)
    res = run(scene, n_steps, method="pallas", state=s0, device=dev,
              repair_k=0, **RESIDENT)
    reuse = run(scene, n_steps, method="pallas", state=s0, device=dev,
                sort_every=4)
    act = res.active
    same_active = bool(torch.equal(act, reuse.active))
    dx = float((res.x[act] - reuse.x[act]).abs().max())
    limit = 1e-3 * scene.params.h
    emit({"phase": "agreement", "preset": "dam3d_100k", "steps": n_steps,
          "a": "resident4auto, repair_k=0", "b": "sort_every=4 reuse",
          "max_abs_dx": dx, "limit": limit, "same_active": same_active})
    check(same_active and dx < limit,
          "resident4auto vs reuse x within 1e-3 h at dam3d_100k")
    a = run(scene, n_steps, method="pallas", state=s0, device=dev, **RESIDENT)
    b = run(scene, n_steps, method="pallas", state=s0, device=dev, **RESIDENT)
    same = bool(torch.equal(a.x, b.x))
    emit({"phase": "determinism", "preset": "dam3d_100k", "steps": n_steps,
          "run": RESIDENT, "bitwise_equal_x": same})
    check(same, "two resident4auto runs give bitwise-equal x")


def phase_profile_resident(name: str, scene, state, n_steps: int, dev):
    """One `n_steps`-step resident4auto dispatch under torch.profiler,
    after one warm dispatch: device time per step by kernel, operations per
    step, busy share, and the host fetches per block."""
    from torch.profiler import ProfilerActivity, profile

    from sph_tpu_torch import make_audited_advance, prime
    from sph_tpu_torch import step as step_mod

    adv = make_audited_advance(scene, "pallas", n_steps, device=dev,
                               **RESIDENT)
    if scene.params.integrator == "leapfrog":
        state = prime(scene, state, "pallas", device=dev)
    state = adv(state)
    torch.cuda.synchronize()
    before = (adv.healed, adv.rebuilds, adv.repaired)
    step_mod.reset_fetches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = adv(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fetches = dict(step_mod.FETCHES)
    rows = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.device_time_total / 1e3 / n_steps,
                         e.count / n_steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    emit({"phase": "profile", "preset": name, "steps": n_steps,
          "run": RESIDENT, "healed": adv.healed - before[0],
          "rebuilds": adv.rebuilds - before[1],
          "repaired": adv.repaired - before[2], "host_fetches": fetches,
          "wall_ms_per_step_profiled": wall / n_steps * 1e3,
          "device_ms_per_step": busy,
          "device_busy_share": busy / (wall / n_steps * 1e3),
          "device_ops_per_step": sum(r[1] for r in rows),
          "top": [{"ms_per_step": ms, "per_step": c, "name": k[:90]}
                  for ms, c, k in rows[:12]]})


def bf16_scene(scene):
    return scene.replace(params=scene.params.replace(precision="bf16"))


def phase_kernels_bf16(preset_name: str, dev):
    """The bf16 K1/K2 on the step-0 slot arrays of a preset: against their
    plain versions, against the fp32 kernels per particle, times, bound."""
    from sph_tpu_torch import init, neighbors, pallas_step as ps, preset
    from sph_tpu_torch import slot_kernels as sk

    scene = preset(preset_name)
    params = bf16_scene(scene).params
    d = params.dim
    state = init(scene, device=dev)
    grid = neighbors.GridSpec.for_scene(scene)
    sg = ps.slot_grid(grid)
    addr = ps.build_addr(state.x, state.active, grid, sg)
    feat = ps.scatter_slots(addr, ps._rel_rows(state.x, state.v, addr), sg)
    feat32 = ps.scatter_slots(addr, ps._pack_rows6(state.x, state.v), sg)
    check(feat.dtype == torch.bfloat16, "bf16 features")
    args = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params, 1,
            sg.cell)
    args32 = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, scene.params)

    rp_k = sk.slot_density(feat, *args)
    rp_p = sk.density_plain(feat, *args)
    f_k = sk.slot_force(feat, rp_k, *args)
    f_p = sk.force_plain(feat, rp_k, *args)
    rp32 = sk.slot_density(feat32, *args32)
    f32 = sk.slot_force(feat32, rp32, *args32)
    torch.cuda.synchronize()
    rho_k, ok = ps._gather_rho(rp_k, addr, sg, params)
    rho_p, _ = ps._gather_rho(rp_p, addr, sg, params)
    rho32, _ = ps._gather_rho(rp32, addr, sg, params)
    check(bool(torch.allclose(rho_k, rho_p, rtol=RHO_RTOL, atol=RHO_ATOL)),
          f"bf16 K1 vs plain at {preset_name}")
    fk, fp, f32g = (ps._gather_f(t, addr, sg, d, ok) for t in (f_k, f_p, f32))
    f_err = float(torch.max(torch.abs(fk - fp)))
    f_scale = float(torch.max(torch.abs(fp)))
    check(f_err / f_scale < F_REL, f"bf16 K2 vs plain at {preset_name}")
    rho_vs32 = float(torch.max(torch.abs(rho_k / rho32 - 1.0)))
    f_vs32 = float(torch.max(torch.abs(fk - f32g))) / float(
        torch.max(torch.abs(f32g)))
    check(bool(torch.allclose(rho_k, rho32, rtol=BF16_RHO_RTOL))
          and f_vs32 < BF16_F_REL, f"bf16 vs fp32 kernels at {preset_name}")
    check(bool(torch.isfinite(rho_k).all() and torch.isfinite(fk).all()),
          f"finite bf16 kernel outputs at {preset_name}")
    hold_to_simple(f"{preset_name} bf16", feat, rp_k, f_k, args)

    counts = pair_counts(feat32, addr, sg, params)
    staged = staged_slots(feat32, addr, sg)
    res = {}
    for name, kern, simple, plain, err in (
        ("slot_density_bf16", lambda: sk.slot_density(feat, *args),
         lambda: sk.slot_density_simple(feat, *args),
         lambda: sk.density_plain(feat, *args),
         float(torch.max(torch.abs(rho_k - rho_p)))),
        ("slot_force_bf16", lambda: sk.slot_force(feat, rp_k, *args),
         lambda: sk.slot_force_simple(feat, rp_k, *args),
         lambda: sk.force_plain(feat, rp_k, *args), f_err),
    ):
        b_ms, b_by = bound(name, feat, addr, sg, d, counts, staged)
        res[name] = {"max_abs_err": err, "bitwise_simple": True,
                     **in_turns(kern, simple), "plain_ms": cuda_ms(plain),
                     "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernels", "preset": preset_name, "precision": "bf16",
          "feat": list(feat.shape), "n_occ": int(addr.n_occ[0]),
          "particles": int(ok.sum()), "pairs": counts,
          "staged_slots": staged,
          "f_max_rel_err": f_err / f_scale,
          "vs_fp32": {"rho_max_rel": rho_vs32, "f_max_rel_of_scale": f_vs32,
                      "limits": [BF16_RHO_RTOL, BF16_F_REL]},
          "kernels": res})
    return res


def phase_kernels_xsub(preset_name: str, dev, xsub: int = 2):
    """K1/K2 with the xsub candidate margin on the step-0 slot arrays of
    the xsub lattice: against their plain versions, times, bound (the
    pairs the function needs are those of the per-step lattice)."""
    from sph_tpu_torch import init, neighbors, pallas_step as ps, preset
    from sph_tpu_torch import slot_kernels as sk

    scene = preset(preset_name)
    params, d = scene.params, scene.params.dim
    state = init(scene, device=dev)
    grid = neighbors.GridSpec.for_scene(scene, xsub=xsub)
    sg, addr, feat = slot_inputs(scene, state, grid=grid)
    args = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params, sg.xsub,
            sg.cell)
    rp_k = sk.slot_density(feat, *args)
    rp_p = sk.density_plain(feat, *args)
    f_k = sk.slot_force(feat, rp_k, *args)
    f_p = sk.force_plain(feat, rp_k, *args)
    torch.cuda.synchronize()
    rho_k, ok = ps._gather_rho(rp_k, addr, sg, params)
    rho_p, _ = ps._gather_rho(rp_p, addr, sg, params)
    check(bool(torch.allclose(rho_k, rho_p, rtol=RHO_RTOL, atol=RHO_ATOL)),
          f"xsub K1 vs plain at {preset_name}")
    fk, fp = (ps._gather_f(t, addr, sg, d, ok) for t in (f_k, f_p))
    f_err = float(torch.max(torch.abs(fk - fp)))
    f_scale = float(torch.max(torch.abs(fp)))
    check(f_err / f_scale < F_REL, f"xsub K2 vs plain at {preset_name}")
    check(int(addr.overflow) == 0, f"no slot-cell overflow at xsub={xsub}")
    hold_to_simple(f"{preset_name} xsub={xsub}", feat, rp_k, f_k, args)
    sg1, addr1, feat1 = slot_inputs(scene, state)
    counts = pair_counts(feat1, addr1, sg1, params)
    res = {}
    for name, kern, simple, plain, err in (
        ("slot_density", lambda: sk.slot_density(feat, *args),
         lambda: sk.slot_density_simple(feat, *args),
         lambda: sk.density_plain(feat, *args),
         float(torch.max(torch.abs(rho_k - rho_p)))),
        ("slot_force", lambda: sk.slot_force(feat, rp_k, *args),
         lambda: sk.slot_force_simple(feat, rp_k, *args),
         lambda: sk.force_plain(feat, rp_k, *args), f_err),
    ):
        b_ms, b_by = bound(name, feat, addr, sg, d, counts)
        res[name] = {"xsub": xsub, "max_abs_err": err, "bitwise_simple": True,
                     **in_turns(kern, simple), "plain_ms": cuda_ms(plain),
                     "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernels", "preset": preset_name, "xsub": xsub,
          "slot_cap": sg.cap, "feat": list(feat.shape),
          "n_occ": int(addr.n_occ[0]), "particles": int(ok.sum()),
          "f_max_rel_err": f_err / f_scale, "kernels": res})
    return res


def phase_bf16_agreement(dev, n_steps: int = 20):
    """bf16 at dam3d_100k: the classic resident block against the reuse
    path, bitwise in x and rho where nothing overflowed (tests/test_bf16.py
    ::test_bf16_resident_bitwise_vs_classic_reuse); bf16 against fp32
    resident4auto, max|dx| below h/16 (the reference's 1.0 at h = 16)."""
    from sph_tpu_torch import init, make_advance, preset, prime, run

    scene = preset("dam3d_100k")
    scene_b = bf16_scene(scene)
    s0 = prime(scene_b, init(scene, device=dev), "pallas", device=dev)
    kw = dict(steps_per_dispatch=n_steps, sort_every=4, device=dev)
    s_a, viol_a = make_advance(scene_b, "pallas", **kw)(s0)
    s_b, viol_b = make_advance(scene_b, "pallas", slot_resident=True,
                               **kw)(s0)
    viol = (int(viol_a), int(viol_b))
    same = bool(torch.equal(s_a.x, s_b.x) and torch.equal(s_a.rho, s_b.rho))
    emit({"phase": "agreement", "preset": "dam3d_100k", "precision": "bf16",
          "steps": n_steps, "a": "sort_every=4 reuse",
          "b": "classic resident block", "violations": viol,
          "bitwise_x_rho": same})
    check(viol == (0, 0) and same, "bf16 resident == reuse bitwise in x, rho")
    i0 = init(scene, device=dev)
    a = run(scene_b, n_steps, method="pallas", state=i0, device=dev,
            **RESIDENT)
    b = run(scene, n_steps, method="pallas", state=i0, device=dev, **RESIDENT)
    act = a.active
    dx = float((a.x[act] - b.x[act]).abs().max())
    limit = scene.params.h / 16
    emit({"phase": "agreement", "preset": "dam3d_100k", "steps": n_steps,
          "a": "bf16 resident4auto", "b": "fp32 resident4auto",
          "max_abs_dx": dx, "limit": limit})
    check(dx < limit, "bf16 vs fp32 x within h/16 after 20 steps")


def phase_packed_scatter(dev, n_steps: int, spd: int = 100):
    """The packed_scatter transport at dam3d_100k: `n_steps` of the
    auto-rebuild resident advance it belongs to (`make_advance(...,
    auto_rebuild=True, packed_scatter=True)`; `run` does not take it), from
    the primed state, with the paths' health checks, its counters, and
    K1/K2 launched once a step plus 4 times per healed block."""
    from sph_tpu_torch import init, make_advance, pallas_step as ps, preset
    from sph_tpu_torch import prime, step as step_mod

    name = "dam3d_100k packed_scatter"
    scene = preset("dam3d_100k")
    state = prime(scene, init(scene, device=dev), "pallas", device=dev)
    adv = make_advance(scene, "pallas", steps_per_dispatch=spd, sort_every=4,
                       slot_resident=True, auto_rebuild=True,
                       packed_scatter=True, device=dev)
    grid = reuse_grid(scene, 4)
    sg = ps.slot_grid(grid)

    def overflow(st):
        return int(ps.build_addr(st.x, st.active, grid, sg).overflow)

    over, n_start = overflow(state), int(state.n_active())
    viol = healed = rebuilds = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(n_steps // spd):
        state, v, h, r = adv(state)
        viol, healed, rebuilds = viol + int(v), healed + h, rebuilds + r
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(name)
    fetches = dict(step_mod.FETCHES)
    peak = torch.cuda.max_memory_allocated()
    over = max(over, overflow(state))
    hl = health(state, scene)
    emit({"phase": "path", "preset": "dam3d_100k", "steps": n_steps,
          "run": {"steps_per_dispatch": spd, **RESIDENT,
                  "auto_rebuild": True, "packed_scatter": True},
          **hl, "particles_at_start": n_start,
          "ms_per_step": wall / n_steps * 1e3,
          "ms_per_step_note": "host clock over the advance's dispatches",
          "peak_bytes": peak, "launches": launches, "overflow": over,
          "policy": {"viol": viol, "healed": healed, "rebuilds": rebuilds},
          "host_fetches": {
              **fetches,
              "per_block": fetches["fetches"] / max(fetches["blocks"], 1)},
          "final_step": int(state.step)})
    check_health(name, hl, n_start, over, (0.90, 1.10))
    check(viol == 0, f"no skin or cap violation at {name}")
    want = n_steps + 4 * healed
    check(launches["slot_density"] == launches["slot_force"] == want,
          f"K1/K2 launched {want} times at {name}")


def phase_options_agreement(dev, n_steps: int = 20):
    """The kernel options against the default at dam3d_100k after
    `n_steps`: row_pair bitwise, per step and resident; xsub=2 resident
    within 1e-3 h; the packed_scatter transport within 3 x 2^-10 cell and
    rho within 1%: one bf16 round trip of a cell-relative coordinate
    (|x - center| < cell/2) moves it by at most 2^-10 cell, above 1e-3 h;
    in the absolute frame it would move by up to 0.5 at x ~ 160."""
    from sph_tpu_torch import init, make_advance, preset, prime, run
    from sph_tpu_torch.neighbors import GridSpec

    scene = preset("dam3d_100k")
    h = scene.params.h
    i0 = init(scene, device=dev)
    out = {}
    for label, kw in (("per step", {}), ("resident4auto", RESIDENT)):
        a = run(scene, n_steps, method="pallas", state=i0, device=dev, **kw)
        b = run(scene, n_steps, method="pallas", state=i0, device=dev,
                row_pair=True, **kw)
        out[f"row_pair {label}"] = same = bool(
            torch.equal(a.x, b.x) and torch.equal(a.v, b.v)
            and torch.equal(a.rho, b.rho))
        check(same, f"row_pair bitwise the default, {label}")
    base = run(scene, n_steps, method="pallas", state=i0, device=dev,
               **RESIDENT)
    xs = run(scene, n_steps, method="pallas", state=i0, device=dev, xsub=2,
             **RESIDENT)
    dx_xsub = float((xs.x - base.x).abs().max())
    out["xsub=2 max_abs_dx"] = dx_xsub
    check(dx_xsub < 1e-3 * h, "xsub=2 within 1e-3 h of the default")
    s0 = prime(scene, i0, "pallas", device=dev)
    kw = dict(steps_per_dispatch=n_steps, sort_every=4, slot_resident=True,
              auto_rebuild=True, device=dev)
    ref, _, h0, r0 = make_advance(scene, "pallas", **kw)(s0)
    pk, viol, h1, r1 = make_advance(scene, "pallas", packed_scatter=True,
                                    **kw)(s0)
    cell = GridSpec.for_scene(scene).cell
    dx_limit, rho_limit = 3 * 2.0 ** -10 * cell, 1e-2
    dx_pk = float((pk.x - ref.x).abs().max())
    rho_pk = float(torch.max(torch.abs(pk.rho / ref.rho - 1.0)))
    out.update({"packed_scatter max_abs_dx": dx_pk,
                "packed_scatter rho_max_rel": rho_pk,
                "packed_scatter counters": [int(viol), h1, r1],
                "default counters": [h0, r0]})
    emit({"phase": "agreement", "preset": "dam3d_100k", "steps": n_steps,
          "limits": {"xsub": 1e-3 * h, "packed_scatter_dx": dx_limit,
                     "packed_scatter_rho": rho_limit}, **out})
    check(int(viol) == 0 and (h1, r1) == (h0, r0),
          "packed_scatter keeps the default's counters")
    check(dx_pk < dx_limit and rho_pk < rho_limit,
          "packed_scatter within 3 x 2^-10 cell and rho within 1%")


def sass_opcodes(lib_path: Path) -> dict:
    """{kernel: {opcode: count}} of the probe kernels, from
    `cuobjdump -sass` on the built library."""
    from sph_tpu_torch import _build

    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = ("probe_bf16" if "bf16" in m.group(1) else "probe_fp32"
                  if "f32" in m.group(1) else None)
            if fn:
                out[fn] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if fn and m:
            out[fn][m.group(1)] = out[fn].get(m.group(1), 0) + 1
    return out


def phase_probe(dev):
    """P1: both kernels bitwise their plain chain on U[0,1) inputs and on
    the probe's own (y = x + 2, all inf); then the probe's entry point
    (`probe_vpu_bf16.main(50)`), counted; plain times; SASS evidence."""
    from sph_tpu_torch import _build, probe_vpu_bf16 as pr

    gen = torch.Generator(device=dev).manual_seed(67)
    uni = [torch.rand((pr.SUB, pr.LANE), generator=gen, device=dev)
           for _ in range(2)]
    res, checks = {}, {}
    for dt, name in ((torch.float32, "probe_fp32"),
                     (torch.bfloat16, "probe_bf16")):
        for kind, (x, y) in (("uniform", [u.to(dt) for u in uni]),
                             ("probe", pr.probe_inputs(dt, dev))):
            got, want = pr.probe(x, y), pr.chain_plain(x, y)
            torch.cuda.synchronize()
            fin = bool(torch.isfinite(got).all())
            inf = bool(torch.isinf(got).all())
            same = bool(torch.equal(got, want))
            checks[f"{name} {kind}"] = {"bitwise": same, "all_finite": fin,
                                        "all_inf": inf}
            check(same and (fin if kind == "uniform" else inf),
                  f"{name} bitwise its plain chain on {kind} inputs")
        x, y = pr.probe_inputs(dt, dev)
        res[name] = {"max_abs_err": 0.0,
                     "plain_ms": cuda_ms(lambda: pr.chain_plain(x, y), n=5,
                                         warm=1)}
    reset_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        timing = pr.main(50)
    launches = read_counts("probe_vpu_bf16.main(50)")
    for name, key in (("probe_fp32", "fp32"), ("probe_bf16", "bf16")):
        t = timing[key]
        res[name].update(launches=launches["probe_f32" if key == "fp32"
                                            else "probe_bf16"],
                         ms=t["direct_ms"], graph_ms=t["ms"],
                         top_s=t["ops_per_s"] / 1e12,
                         bound_ms=t["bound_ms"], bound_by=t["bound_by"])
    check(res["probe_fp32"]["launches"] == res["probe_bf16"]["launches"]
          == 200, "the probe's run ran each kernel 4 x 50 times (warm-up, "
          "two graph replays, direct launches)")
    ops = sass_opcodes(_build._LOADED["probe_kernels"].path)
    bf16_packed = sorted(k for k in ops.get("probe_bf16", {})
                         if re.match(r"H(ADD|MUL|FMA|MNMX|MIN|MAX)2.*BF16", k))
    check(bool(bf16_packed), "packed bf16 instructions in the bf16 kernel")
    check("FFMA" not in ops.get("probe_fp32", {}),
          "no FFMA in the fp32 probe kernel")
    emit({"phase": "sass", "kernels": ops, "packed_bf16_opcodes": bf16_packed})
    emit({"phase": "probe", "checks": checks,
          "printed": printed.getvalue().strip().splitlines(),
          "ratio_bf16_over_fp32": timing["ratio"],
          "sm_clock_mhz": timing["sm_clock_mhz"], "sms": timing["sms"],
          "kernels": res})
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import sph_tpu_torch as sph  # without the package: fail before any output

    dev = torch.device("cuda")
    smi = smi_line()
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})
    phase_build()
    settled, scene_e = sph.load_checkpoint(str(SETTLED), device=dev)
    check(int(settled.step) == 260000 and int(settled.n_active()) == 53944,
          "the settled emitters3d checkpoint is the committed one")
    at = {p: phase_kernels(p, dev) for p in ("dam3d_100k", "splash3d_1m")}
    at["emitters3d@settled"] = {
        **phase_kernels("emitters3d@settled", dev, settled),
        **phase_kernels_packed(dev, settled, scene_e),
    }
    # the same check at the shapes of the sort_every=4 path
    at_reuse = phase_kernels_packed(dev, settled, scene_e,
                                    grid=reuse_grid(scene_e, 4),
                                    lattice="sort_every=4")
    # K1/K2 on the skinned lattice the resident paths run on
    at_skin = {p: phase_kernels(p, dev, grid=reuse_grid(sph.preset(p), 4),
                                lattice="sort_every=4")
               for p in ("dam3d_100k", "splash3d_1m")}

    runs = {}
    for name in ("dam3d_100k", "splash3d_1m"):
        scene, n_steps = sph.preset(name), DEPTH[name]
        runs[name] = phase_path(
            name, scene, sph.init(scene, device=dev), n_steps, dev,
            want={"slot_density": n_steps + 1, "slot_force": n_steps + 1,
                  "packed_density": 0, "packed_force": 0},
            rho_band=(0.90, 1.10))
    c0 = scene_e.params.sound_speed
    n_steps = DEPTH["emitters3d@settled"]
    runs["packed"] = phase_path(
        "emitters3d@settled", scene_e, settled, n_steps, dev,
        run_kw=dict(packed_rows=True),
        want={"packed_density": n_steps, "packed_force": n_steps,
              "slot_density": 0, "slot_force": 0},
        vmax_limit=3.0 * c0)

    # dispatches of (at most) 100 steps; each one that the audit rejects
    # is re-run per step on the slot layout, i.e. on K1/K2
    def reran(n: int) -> bool:
        return n <= n_steps and n % min(n_steps, 100) == 0

    runs["reuse"] = phase_path(
        "emitters3d@settled", scene_e, settled, n_steps, dev,
        run_kw=dict(packed_rows=True, sort_every=4),
        want={"packed_density": n_steps, "packed_force": n_steps,
              "slot_density": reran, "slot_force": reran},
        vmax_limit=3.0 * c0)
    check(runs["reuse"]["launches"]["slot_density"]
          == runs["reuse"]["launches"]["slot_force"], "K1 and K2 re-run together")
    check(runs["reuse"]["final_step"] == runs["packed"]["final_step"]
          == 260000 + n_steps, "every step taken from step 260,000")
    phase_agreement(dev, settled, scene_e)
    phase_determinism(dev, settled, scene_e, runs["packed"]["state"])
    phase_no_sync(dev, settled, scene_e)
    for name in ("dam3d_100k", "splash3d_1m"):
        scene = sph.preset(name)
        phase_profile(name, scene, sph.init(scene, device=dev),
                      10 if name == "dam3d_100k" else 5, dev)
    phase_profile("emitters3d@settled", scene_e, settled, 10, dev,
                  packed_rows=True)
    phase_profile("emitters3d@settled", scene_e, settled, 10, dev)
    phase_profile("emitters3d@settled", scene_e, settled, 12, dev,
                  sort_every=4, packed_rows=True)

    # K5 and its entry point, then the production default on each path
    stage = {p: phase_stage(p, dev) for p in ("dam3d_100k", "splash3d_1m")}
    for name in ("dam3d_100k", "splash3d_1m"):
        scene, n_steps = sph.preset(name), DEPTH[name]
        out = runs[f"resident:{name}"] = phase_path(
            name, scene, sph.init(scene, device=dev), n_steps, dev,
            run_kw=dict(RESIDENT), rho_band=(0.90, 1.10))
        launches = out["launches"]
        want = resident_launches(
            out, n_steps, int(scene.params.integrator == "leapfrog"))
        check(launches["slot_density"] == launches["slot_force"] == want,
              f"K1/K2 launched {want} times on resident4auto at {name}")
        check(launches["packed_density"] == launches["packed_force"]
              == launches["stage_transpose"] == 0,
              f"no K3/K4/K5 launch on resident4auto at {name}")
        check(out["policy"]["repair_k"] == sph.step.DEFAULT_REPAIR_K,
              f"repair_k resolves to the production default at {name}")
    n_e = DEPTH["emitters3d@settled"]
    fits = sph.packed_fits(scene_e, settled, 4)
    out = runs["resident:auto"] = phase_path(
        "emitters3d@settled", scene_e, settled, n_e, dev,
        run_kw=dict(RESIDENT, packed_rows=None), vmax_limit=3.0 * c0)
    launches, healed = out["launches"], out["policy"]["healed"]
    packed_steps = launches["packed_density"]
    slot_steps = launches["slot_density"] - 4 * healed
    emit({"phase": "packed_auto", "preset": "emitters3d@settled",
          "packed_fits": fits,
          "first_dispatch": "packed" if packed_steps else "slot",
          "final_mode": out["policy"]["modes"][-1],
          "packed_steps": packed_steps, "slot_steps": slot_steps})
    check(launches["packed_force"] == packed_steps
          and launches["slot_force"] == launches["slot_density"]
          and launches["stage_transpose"] == 0,
          "K3 with K4 and K1 with K2 on the packed auto policy")
    check((packed_steps > 0) == fits,
          "the packed auto policy's first dispatch follows packed_fits")
    check(packed_steps % min(n_e, 100) == 0
          and packed_steps + slot_steps == n_e,
          "each 100-step dispatch on one layout, every step taken once")
    mode = out["policy"]["modes"][-1]
    check(mode in ("packed", "slot") and (slot_steps == 0 or mode == "slot")
          and (mode == "slot" or packed_steps == n_e),
          "the policy's final mode follows the layouts it ran")
    out = runs["resident:packed"] = phase_path(
        "emitters3d@settled", scene_e, settled, n_e, dev,
        run_kw=dict(RESIDENT, packed_rows=True), vmax_limit=3.0 * c0)
    launches, healed = out["launches"], out["policy"]["healed"]
    check(launches["packed_density"] == launches["packed_force"] == n_e
          and launches["slot_density"] == launches["slot_force"] == 4 * healed,
          "pinned packed resident: K3/K4 once a step, K1/K2 only in heals")
    phase_resident_agreement(dev)
    for name, n_prof in (("dam3d_100k", 12), ("splash3d_1m", 12)):
        scene = sph.preset(name)
        phase_profile_resident(name, scene, sph.init(scene, device=dev),
                               n_prof, dev)

    # this slice: the kernel options that are off by default, and P1
    at_bf16 = {p: phase_kernels_bf16(p, dev)
               for p in ("dam3d_100k", "splash3d_1m")}
    at_xsub = phase_kernels_xsub("dam3d_100k", dev)
    for name in ("dam3d_100k", "splash3d_1m"):
        scene_b, n_steps = bf16_scene(sph.preset(name)), DEPTH[name]
        primes = int(scene_b.params.integrator == "leapfrog")
        runs[f"bf16:{name}"] = phase_path(
            f"{name} bf16", scene_b, sph.init(scene_b, device=dev), n_steps,
            dev, want={"slot_density_bf16": n_steps + primes,
                       "slot_force_bf16": n_steps + primes,
                       "slot_density": 0, "slot_force": 0},
            rho_band=(0.90, 1.10))
        out = runs[f"bf16 resident:{name}"] = phase_path(
            f"{name} bf16", scene_b, sph.init(scene_b, device=dev), n_steps,
            dev, run_kw=dict(RESIDENT), rho_band=(0.90, 1.10))
        launches, want = out["launches"], resident_launches(out, n_steps,
                                                             primes)
        check(launches["slot_density_bf16"] == launches["slot_force_bf16"]
              == want and launches["slot_density"] == 0,
              f"bf16 K1/K2 launched {want} times on bf16 resident4auto "
              f"at {name}")
        check(out["policy"]["repair_k"] == 0 == out["policy"]["repaired"],
              f"repair_k resolves to 0 under bf16 at {name}")
    phase_bf16_agreement(dev)

    scene, n_steps = sph.preset("dam3d_100k"), DEPTH["dam3d_100k"]
    phase_packed_scatter(dev, n_steps)
    options = {
        "xsub": phase_path(
            "dam3d_100k", scene, sph.init(scene, device=dev), n_steps, dev,
            run_kw=dict(xsub=2), want={"slot_density": n_steps + 1,
                                       "slot_force": n_steps + 1},
            rho_band=(0.90, 1.10)),
    }
    for opt in ("xsub", "row_pair"):
        options[f"{opt} resident"] = phase_path(
            "dam3d_100k", scene, sph.init(scene, device=dev), n_steps, dev,
            run_kw=dict(RESIDENT, **{opt: 2 if opt == "xsub" else True}),
            rho_band=(0.90, 1.10))
    for opt, out in options.items():
        if "policy" not in out:
            continue
        want = resident_launches(out, n_steps, 1)
        check(out["launches"]["slot_density"]
              == out["launches"]["slot_force"] == want,
              f"K1/K2 launched {want} times on {opt} at dam3d_100k")
        check(out["policy"]["repair_k"] == 0,
              f"no repair on {opt} (the reference's gates)")
    phase_options_agreement(dev)
    probe_res = phase_probe(dev)

    def resident(name):
        return {"resident4auto": {
            p: runs[f"resident:{p}"]["launches"][name]
            for p in ("dam3d_100k", "splash3d_1m", "auto", "packed")}}

    kernels = []
    for name in ("slot_density", "slot_force"):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": runs["dam3d_100k"]["launches"][name],
            **at["dam3d_100k"][name], "library_ms": None,
            "at_scale": {"preset": "splash3d_1m",
                         "launches": runs["splash3d_1m"]["launches"][name],
                         **at["splash3d_1m"][name]},
            "at_settled": {"preset": "emitters3d@settled",
                           "launches": runs["reuse"]["launches"][name],
                           **at["emitters3d@settled"][name]},
            "with_xsub": {"preset": "dam3d_100k",
                          "launches": options["xsub"]["launches"][name],
                          **at_xsub[name]},
            "at_skinned": {
                p: {"lattice": "sort_every=4",
                    "launches": runs[f"resident:{p}"]["launches"][name],
                    **at_skin[p][name]}
                for p in ("dam3d_100k", "splash3d_1m")},
            **resident(name),
        })
        bname = f"{name}_bf16"
        kernels.append({
            "name": bname, "route": "cuda", "source": SOURCE[bname],
            "replaces": REPLACES[bname],
            "launches": runs["bf16:dam3d_100k"]["launches"][bname],
            **at_bf16["dam3d_100k"][bname], "library_ms": None,
            "at_scale": {"preset": "splash3d_1m",
                         "launches": runs["bf16:splash3d_1m"]["launches"][bname],
                         **at_bf16["splash3d_1m"][bname]},
            "resident4auto": {
                p: runs[f"bf16 resident:{p}"]["launches"][bname]
                for p in ("dam3d_100k", "splash3d_1m")},
        })
    for name in ("packed_density", "packed_force"):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": runs["packed"]["launches"][name],
            **at["emitters3d@settled"][name], "library_ms": None,
            "with_reuse": {"lattice": "sort_every=4",
                           "launches": runs["reuse"]["launches"][name],
                           **at_reuse[name]},
            **resident(name),
        })
    name = "stage_transpose"
    kernels.append({
        "name": name, "route": "cuda", "source": SOURCE[name],
        "replaces": REPLACES[name],
        "launches": stage["dam3d_100k"][1], **stage["dam3d_100k"][0],
        "at_scale": {"preset": "splash3d_1m",
                     "launches": stage["splash3d_1m"][1],
                     **stage["splash3d_1m"][0]},
        **resident(name),
    })
    for name in ("probe_fp32", "probe_bf16"):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], **probe_res[name],
            "library_ms": None,
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
