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
 26. kernels  (run with phase 3) K1/K2 at dam3d_100k and splash3d_1m on the
              cap-8 lattice of the adaptive policy (its occupancy-fit skin,
              `step.cap8_skin`, on the step-0 state): phase 3's checks,
              bitwise yardstick, times and bound
 27. path     the cap-8 policy, run(..., sort_every=4, slot_resident=True,
              adaptive_cap=True) in one dispatch, at dam3d_100k (200 steps)
              and splash3d_1m (20): phase 14's checks, the skin, mode and
              heals; in turns with resident4auto the host ms/step and the
              device ms a step of a 12-step dispatch (profile); x of the two
              after 20 steps within 1e-3 h
 28. path     a jet (dam3d_100k's block at 2000 along x) outgrows cap 8:
              the policy switches to the default cap, and the switching
              dispatch equals the per-step path bitwise
 29. path     method="grid" (plain PyTorch, no kernel) at dam2d_10k (200
              steps) and dam3d_100k (10): health, no kernel launched,
              ms/step; against method="pallas" after 10 steps, x within
              1e-3 h
 30. cli      `python -m sph_tpu_torch.cli` in subprocesses: run dam3d_100k
              (--method auto, --render: metrics.jsonl finite with
              advance_mode and no cap dropped, PNGs that decode), run
              splash3d_1m --adaptive-cap, run emitters3d --resume from the
              checkpoint, run dam2d_10k --debug, record dam2d_10k (a
              10-frame APNG from the native encoder), a contradictory flag
              set (exit 2, one line) and the card hidden (exit 1, one line)
 31. decomp_dp  the particle-DP step (`decomp.make_dp_step`) in a one-rank
              NCCL world at dam2d_10k, 10 steps: bitwise the naive step
              (x, v, acc, rho, p); ms/step of both
 32. decomp_slab  run(scene, n, method="pallas", shards=1) in the same
              world at dam3d_100k (200 steps) and splash3d_1m (20), one
              dispatch: K1/K2 through the split API on the slab-local
              lattice, launched n + 1 times (prime included), one spec
              (no overflow, no re-spec), health, and against the
              single-device per-step run slot by slot: the active count
              exactly, x within 1e-4 of the position scale; host ms/step
              of both in turns, device ms/step of both (profile), the
              split build, scatter_rp and a ghost compaction timed, and
              the host time of the spec, the shard and the gather
 33. kernels  K1 and K2 on rank 1's slab-local lattice of a 4-slab
              dam3d_100k (ci_offset != 0) with both neighbors' ghosts, K2
              on rp from scatter_rp with the ghosts' rho/p as their owners
              compute them: bitwise their yardsticks, phase 3's tolerances
              against the plain versions, the locals' rho against the
              single-device K1, K1's own EOS p against PyTorch's; times,
              bound
 34. decomp_ranks  four processes on the one card (gloo, cuda:0; this
              script with --decomp-rank) run run(preset("dam3d_100k"), 100,
              method="pallas", shards=4, steps_per_dispatch=50) with a
              frame_callback: frames at [50, 100] on every rank, K1/K2
              launched 101 times a rank, ranks 1-3 on shifted lattices,
              one spec; the gathered state's health and, against the
              single-device per-step run, the active count exactly and x
              within 1e-4 of scale by nearest neighbor; then the slab
              fast path on the same ranks,
              run(..., sort_every=4, slot_resident=True, shards=4) in
              dispatches of 20: frames after each, one spec, every rank's
              counters (heals, repairs, rebuilds, mode) equal, K1/K2
              launched 101 + 4 per healed block, against the single-device
              resident4auto run of the same dispatches by nearest
              neighbor; the same fast path, with the same checks, on the
              tank with a dart (`dart_scene`), which is repaired in place
              mid-dispatch, and on emitters3d@settled for EMIT_STEPS
              steps, whose emission at step 260,036 forces a rebuild of
              every rank mid-dispatch; and each rank runs phase 38's jet
              sequence
 35. decomp_fast  the slab fast path run(scene, n, method="pallas",
              sort_every=4, slot_resident=True, shards=1) in the one-rank
              NCCL world at dam3d_100k (200 steps) and splash3d_1m (20),
              one dispatch: health, one spec, the policy's counters and
              host fetches per block, K1/K2 launched n + 1 + 4 per healed
              block, against the single-device resident4auto run slot by
              slot (active count exactly, x within 1e-4 of scale); host
              ms/step in turns with resident4auto and the per-step
              run(shards=1); device ms and operations a step of a 12-step
              dispatch of each (profile)
 36. decomp_classic  the fast path's classic form (slot_resident=False)
              through make_audited_spatial_advance at dam3d_100k, one
              200-step dispatch: health, K1/K2 launched once a step (twice
              after an exact re-run), against the single-device
              sort_every=4 reuse run slot by slot
 37. kernels  (with phase 33) K1 and K2 on rank 1's skinned slab-local
              lattice (the skin of sort_every=4) of a 4-slab dam3d_100k
              with the auto-rebuild path's 2·(h + skin)-deep ghost bands:
              phase 33's checks, times and bound
 38. decomp_heal  the jet of phase 28, at 8000 along x, under
              make_audited_spatial_advance
              (slot-resident auto-rebuild, 8-step dispatches, re-probing
              every 2) in the one-rank world: every block of three
              dispatches heals, the advance demotes after the second and
              stays demoted on its re-probe, K1/K2 launched 8 times a
              block, and the first dispatch is bitwise the per-step slab
              advance from its input
 39. decomp_pencil  pencils, run(scene, n, method="pallas", shards=(1, 1))
              in the one-rank NCCL world at dam3d_100k (200 steps) and
              splash3d_1m (20), one dispatch: health, one spec, K1/K2
              launched n + 1 times, against the single-device per-step run
              slot by slot (the active count exactly, x within 1e-4 of
              scale), whether it is bitwise the per-step run(shards=1)
              slabs; host ms/step in turns with those slabs, device ms
              and operations a step of a 12-step dispatch of each
 40. kernels  (with phase 33) K1 and K2 on rank (1, 1)'s pencil-local
              lattice of a 2x2 dam3d_100k (`pc`: restricted along axes 0
              and 2, ci_offset != 0 on both) with the ghosts of both
              phases, corners by two hops: phase 33's checks, times, bound
 41. decomp_pencil_ranks  (in phase 34's four rank processes) run(
              preset("dam3d_100k"), 100, method="pallas", shards=(2, 2),
              steps_per_dispatch=50) with a frame_callback: frames at [50,
              100], K1/K2 launched 101 times a rank, every rank's lattice
              restricted on both cut axes and shifted where its grid
              coordinate is not 0, one spec; against the single-device
              per-step run by nearest neighbor: the active count exactly,
              x within 1e-4 of scale; host ms/step a rank
 42. cli_shards  the command line's --shards under `python -m
              torch.distributed.run --standalone`: run dam3d_100k --shards
              1 on one process (--method auto, the slab fast path over
              NCCL; the reference's decomposed keys, one line a frame,
              PNGs that decode), run dam3d_100k --shards 2x2 on four
              processes with --device cuda:0 (gloo; the pencil note, mesh
              "2x2", one metrics.jsonl from rank 0, every process exits
              0), record dam2d_10k --shards 2 on two (one APNG that
              decodes), run dam2d_10k --shards 1x1 as a plain command
              (a one-rank NCCL group of its own), and --shards 2x2 as one
              process (exit 2, one line naming torchrun)
 43. cli_frames  the reference CLI's frame split: run dam2d_10k
              --steps-per-frame 250 (--method auto: 3 dispatches of 84)
              and --method pallas --steps-per-frame 101 (2 of 51), two
              frames each: metrics.jsonl's step 252, 504 and 102, 204
 44. bench    (after phases 46-50) the step at which dam2d_10k's classic
              resident4 row first raises a skin violation, beyond the steps
              any row runs here; `python -m sph_tpu_torch.cli bench --steps
              BENCH_STEPS`, the whole table in one subprocess: exit 0,
              every row at full size with n the scene's active count (the
              two @settled rows from phase 46's checkpoints), each row's
              ms/step and particle-steps/s; the flagship row
              splash3d_1m/resident4auto in this process through
              `bench_step.bench_one`: the staged K1/K2 launched, no
              yardstick; emitters3d@settled/resident4auto the same way, on
              packed rows (K3/K4) or slots (K1/K2) as `packed_fits` says at
              its checkpoint; and `--assert-floor --only
              splash3d_1m/resident4auto` exits 0
 45. slot_pass  (run with phases 26 and 37) the resident block's two
              passes, slot_pre (kick, drift, the feature array) and
              slot_post (body forces, integration, walls, the drift audit
              relaxed by membership), at dam3d_100k and splash3d_1m on the
              skinned cap-16 lattice of sort_every=4 and on the cap-8
              lattice, and on rank 1's skinned slab-local lattice (ghosts,
              ci_offset, faces), from a carry moved ~0.3 cell off its build
              positions: three steps (the first the block's) by the kernels
              and by their plain versions, every element of the block's
              arrays bitwise, the violation counts and the rebuild
              predicate's (the block's last slot_post) equal; their times
              (CUDA events over host launches, graph replay), the plain
              versions', the block's first slot_pre, and the byte bound
              over the occupied groups
 46. settled  `python -m sph_tpu_torch.make_settled_state CONFIG`, a
              subprocess for each of its two configs (exit 0), at the
              reference's criteria: splash3d_1m at step 3000 with all
              1,080,000 particles, finite, mean rho/rho0 in [0.90, 1.10],
              max|v| < c0; emitters3d filled to at least 20,000 particles
              at a step that is a multiple of 100, at most 120,000, finite;
              process seconds and the maker's ms a step
 47. soak_1m  `soak_1m.soak(5000)` in this process: the soak-average,
              healed, repaired, rebuilds, the cap-8 -> cap-16 switch step,
              final mode, rho/rho0, max|v|, peak memory; finite, every
              particle kept, rho/rho0 in [0.90, 1.10], max|v| < c0, the
              switch by step 1000, heals in fewer than half the blocks,
              repairs; K1/K2 once a step, the prime and 4 a healed block
 48. soak_spatial  `soak_spatial.soak(2000, shards=1)` in a one-rank NCCL
              group of its own: n_act == n at every probe, finite, the
              elastic recoveries counted; the launches as phase 47's
 49. soak_emitters  `soak_emitters.soak` of vortex2d (5000 steps: the
              demotion to per step) and of emitters3d (EMITTERS_SOAK_STEPS
              of the reference's 260,000, `reduced`; its final state saved
              to out/, gitignored): finite, every emitted particle kept,
              modes, healed, repaired; one layout's kernels a step
 50. spill, sweep  `measure_spill` (dam3d_100k, 3000 steps, cap 8) and
              `bench_sweep` (dam3d_100k, 50 steps): caps 8, 16 and 32 each
              run, no FAIL, K1/K2 launched as their plans imply; then K1/K2
              on dam3d_100k's cap-32 lattice against their plain versions
              and bitwise their yardsticks, with phase 3's times and bound
  Every path counts the passes' launches too: none off the resident
  paths; on them slot_post once a step and slot_pre once a step under
  leapfrog (once a block under Euler), unless a dispatch ran demoted.
  Phase 18 also profiles pinned packed rows at emitters3d@settled.
  then the {"kernels": [...]} summary, the nvidia-smi line, and last
  {"ok": true, "device": {...}}.

Phases 31-32, 35-36, 38 and 39 run in a one-rank NCCL process group made
through a file store in a temporary directory.  Every path reads its launch counts
through `read_counts`, which checks that
no yardstick and no variant of a launch choice ran in it.  Any failed check
raises and the script exits non-zero without the last line.  It imports
neither JAX nor `sph_tpu`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time
import zlib
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
    # no pallas_call: XLA fuses the resident block's body inside lax.scan
    "slot_pre": "sph_tpu/step.py:1032-1093 (run_block's kick, drift and "
                "mk_feat, fused by XLA inside lax.scan; no pallas_call)",
    "slot_post": "sph_tpu/step.py:1032-1093 (run_block's body_forces, "
                 "integration, clamp_slot and audit, fused by XLA inside "
                 "lax.scan; no pallas_call)",
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
    "slot_pre": "sph_tpu_torch/csrc/slot_pass_kernels.cu",
    "slot_post": "sph_tpu_torch/csrc/slot_pass_kernels.cu",
    "probe_bf16": "sph_tpu_torch/csrc/probe_kernels.cu",
}
# the production default (`sph-tpu run`'s --method auto)
RESIDENT = dict(sort_every=4, slot_resident=True)
RHO_RTOL, RHO_ATOL, F_REL = 1e-5, 1e-6, 3e-5
# bf16 against fp32 per particle (tests/test_bf16.py:50-54)
BF16_RHO_RTOL, BF16_F_REL = 2e-2, 6e-2
N_TIMED = 20
# steps of the slot_pass check, the first the block's
SLOT_PASS_STEPS = 3
# steps each path is driven for
DEPTH = {"dam3d_100k": 200, "splash3d_1m": 20, "emitters3d@settled": 200}
SETTLED = Path(__file__).resolve().parent / "bench" / ".settled_emitters3d_full.npz"


T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:      # when in the run each phase line was printed
        obj = {**obj, "at_s": round(time.perf_counter() - T0, 1)}
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
              for cap, xm in ((16, 1), (8, 1), (8, 2), (32, 1))}})
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
    built on `grid` (default: the per-step lattice), which drop no
    particle."""
    from sph_tpu_torch import init, pallas_step as ps, preset
    from sph_tpu_torch import slot_kernels as sk

    scene = preset(preset_name.split("@")[0])
    params = scene.params
    if state is None:
        state = init(scene, device=dev)
    sg, addr, feat = slot_inputs(scene, state, grid=grid)
    args = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params)
    where = f"{preset_name}, lattice {lattice}"
    check(int(addr.overflow) == 0, f"no particle dropped at {where}")

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
          "slot_cap": sg.cap, "cell": grid.cell if grid is not None else None,
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
    from sph_tpu_torch import slot_pass
    from sph_tpu_torch import stage_kernels as st, step as step_mod

    sk.reset_launches()
    pk.reset_launches()
    st.reset_launches()
    pr.reset_launches()
    slot_pass.reset_launches()
    step_mod.reset_fetches()


def read_counts(name: str) -> dict:
    """The launch counts of the path `name` just drove; no path may launch
    a yardstick (`*_simple`) or a measured launch choice (`*_variant`)."""
    from sph_tpu_torch import packed_kernels as pk, slot_kernels as sk
    from sph_tpu_torch import probe_vpu_bf16 as pr
    from sph_tpu_torch import slot_pass, stage_kernels as st

    counts = {**sk.LAUNCHES, **pk.LAUNCHES, **st.LAUNCHES, **pr.LAUNCHES,
              **slot_pass.LAUNCHES}
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
            "cap8_skins": [a.skin for a in made if hasattr(a, "skin")],
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
    check_slot_pass(name, launches, n_steps, scene,
                    out["policy"]["modes"] if "policy" in out else None)
    for kernel, n in (want or {}).items():
        good = n(launches[kernel]) if callable(n) else launches[kernel] == n
        check(good, f"{kernel} launched {launches[kernel]} times at {name}")
    out["state"] = state
    return out


def check_slot_pass(name: str, launches: dict, n_steps: int, scene,
                    modes=None) -> None:
    """The resident block's passes on a path: none on a path that is not
    slot-resident (`modes` None); on one that is, slot_post once a step and
    slot_pre once a step under leapfrog (its kick and drift), once a block
    under Euler (the block's first), while no dispatch ran demoted to the
    per-step path."""
    pre, post = launches["slot_pre"], launches["slot_post"]
    if modes is None:
        check(pre == post == 0, f"no slot pass launched at {name}")
        return
    if set(modes) <= {"resident", "slot", "packed", "cap8", "cap16"}:
        leap = scene.params.integrator == "leapfrog"
        want = n_steps if leap else n_steps // RESIDENT["sort_every"]
        check(post == n_steps and pre == want,
              f"slot_pre/slot_post launched {pre}/{post} times at {name} "
              f"(want {want}/{n_steps})")
    else:
        check(0 < post <= n_steps, f"slot_post launched at {name}")


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


def phase_profile_resident(name: str, scene, state, n_steps: int, dev,
                           **policy):
    """One `n_steps`-step resident4auto dispatch (with `policy`, e.g.
    adaptive_cap=True, on top) under torch.profiler, after one warm
    dispatch: device time per step by kernel, operations per step, busy
    share, and the host fetches per block."""
    from torch.profiler import ProfilerActivity, profile

    from sph_tpu_torch import make_audited_advance, prime
    from sph_tpu_torch import step as step_mod

    adv = make_audited_advance(scene, "pallas", n_steps, device=dev,
                               **RESIDENT, **policy)
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
          "run": {**RESIDENT, **policy}, "mode": adv.mode,
          "cap8_skin": getattr(adv, "skin", None),
          "healed": adv.healed - before[0],
          "rebuilds": adv.rebuilds - before[1],
          "repaired": adv.repaired - before[2], "host_fetches": fetches,
          "wall_ms_per_step_profiled": wall / n_steps * 1e3,
          "device_ms_per_step": busy,
          "device_busy_share": busy / (wall / n_steps * 1e3),
          "device_ops_per_step": sum(r[1] for r in rows),
          "top": [{"ms_per_step": ms, "per_step": c, "name": k[:90]}
                  for ms, c, k in rows[:12]]})
    return busy


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


# --- the cap-8 policy, the grid method and the command line ----------------

CAP8 = dict(RESIDENT, adaptive_cap=True)
ROOT = Path(__file__).resolve().parent


def slot_pass_bound(name: str, addr, movb, d: int, params) -> tuple:
    """(bound_ms, bound_by) of one in-place slot_pre (leapfrog kick and
    drift) or slot_post on these arrays: the bytes of the slots of the
    occupied groups (each input read once, each output written once) over
    the HBM rate, and the operations of the movable slots over the fp32
    rate."""
    n = int(addr.n_occ[0])
    slots = int((addr.gcounts[1:n + 1, 0] > 0).sum()) * 128
    n_mov = int(movb.sum())
    vec = d * 4
    if name == "slot_pre":      # read x, v, acc, mov; write x, v
        moved = slots * (5 * vec + 1)
        ops = n_mov * 6 * d
    else:                       # read x, v, rho, f, x0, mov; write v, acc
        euler_or_clamp = (params.integrator != "leapfrog"
                          or params.boundary_mode == "clamp")
        moved = slots * ((6 + euler_or_clamp) * vec + 4 + 1)
        penalty = 10 * d if params.boundary_mode == "penalty" else 0
        ops = n_mov * (2 * d + penalty + 2 * d + 1 + 2 * d + 3 * d + 4 * d)
    t_bytes = moved / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_slot_pass(name: str, dev, grid=None, lattice: str = "sort_every=4",
                    slab=None) -> dict:
    """slot_pre and slot_post against their plain versions on the slot
    arrays of `name`'s resident block (default: the skinned lattice of
    sort_every=4; `grid` another, e.g. cap 8; `slab` = (scene, s0, grid,
    slots, ghosts, ci_offset, faces) a slab-local lattice with its ghosts,
    ci_offset and faces), from a carry whose movable slots were moved
    ~0.3 cell off their build positions with a flow's velocities and
    accelerations, so the audit fires and membership decides: each of
    SLOT_PASS_STEPS steps (the first the block's) run by the kernels and by
    the plain versions, K1/K2 between, every element of the block's
    arrays bitwise and the violation count equal.  Then their times by
    CUDA events over host launches and by graph replay, the plain
    versions', the block's first slot_pre, and the byte bound over the
    occupied groups."""
    from sph_tpu_torch import init, pallas_step as ps, preset, prime
    from sph_tpu_torch import slot_pass
    from sph_tpu_torch import step as step_mod

    if slab is None:
        scene = preset(name)
        leap = scene.params.integrator == "leapfrog"
        state = init(scene, device=dev)
        if leap:
            state = prime(scene, state, "pallas", device=dev)
        grid = grid or reuse_grid(scene, RESIDENT["sort_every"])
        sg = ps.slot_grid(grid)
        c = step_mod._residency(state, grid, sg, scene.params.dim,
                                scene.params.dt, leap, True)
        ci, faces = None, None
    else:
        scene, state, grid, (x, v, act), ghosts, ci, faces = slab
        sg = ps.slot_grid(grid)
        cx = torch.cat([x] + [g[0] for g in ghosts])
        cv = torch.cat([v] + [g[1] for g in ghosts])
        c_act = torch.cat([act] + [g[2] for g in ghosts])
        mov = torch.cat([act] + [torch.zeros_like(g[2]) for g in ghosts])
        c = step_mod._scatter_residency(cx, cv, c_act, mov, grid, sg, True,
                                        ci)
    params = scene.params
    d, dt = params.dim, params.dt
    leap = params.integrator == "leapfrog"
    addr, movb = c["addr"], c["movb"]
    skin = grid.cell - params.h
    half2 = (0.5 * skin) ** 2
    gen = torch.Generator(device=dev).manual_seed(12)

    def noise(scale):
        return torch.randn(c["xs"].shape, generator=gen, device=dev) * scale

    xs = torch.where(movb, c["xs"] + noise(0.3 * grid.cell), c["xs"])
    vs = torch.where(movb, c["vs"] + noise(0.1 * params.sound_speed),
                     c["vs"])
    acc = torch.where(movb, noise(3e3), 0.0)
    step0 = state.step
    sp = step_mod._SlotPhysics(scene, grid, sg, dev)
    budget = 0.5 * skin
    plan = slot_pass.PostPlan(sp, leap, half2, True, ci, faces, budget,
                              RESIDENT["sort_every"])
    blocks = [slot_pass.SlotBlock(sg.c_rows, sg.lanes, d, False, dev)
              for _ in range(2)]
    ways = ((slot_pass.slot_pre, slot_pass.slot_post),
            (slot_pass.slot_pre_plain, slot_pass.slot_post_plain))
    counts, err = [], {"slot_pre": 0.0, "slot_post": 0.0}
    where = f"{name}, lattice {lattice}"
    for i in range(SLOT_PASS_STEPS):
        for blk, (pre, post) in zip(blocks, ways):
            src = (xs, vs, acc) if i == 0 else (blk.xs, blk.vs, blk.acc)
            pre(blk, *src, movb, addr.gcounts, addr.n_occ, dt, leap, leap,
                i == 0)
        torch.cuda.synchronize()
        a, b = blocks
        err["slot_pre"] = max(err["slot_pre"],
                              float((a.feat - b.feat).abs().max()))
        check(bitwise(a.feat, b.feat), f"slot_pre bitwise plain at {where}, "
                                       f"step {i}")
        last = i == SLOT_PASS_STEPS - 1
        for blk, (pre, post) in zip(blocks, ways):
            rp = ps._call_density(blk.feat, addr, sg, params, c["jb"])
            f = ps._call_force(blk.feat, rp, addr, sg, params, c["jb"])
            post(blk, rp, f, c["x0s"], movb, addr, plan, step0, i, last)
        torch.cuda.synchronize()
        err["slot_post"] = max(err["slot_post"],
                               float((a.feat - b.feat).abs().max()),
                               float((a.acc - b.acc).abs().max()))
        counts.append((int(a.count), int(b.count)))
        check(bitwise(a.feat, b.feat) and bitwise(a.acc, b.acc)
              and counts[-1][0] == counts[-1][1],
              f"slot_post bitwise plain at {where}, step {i}")
    risky = (int(a.risky), int(b.risky))
    check(risky[0] == risky[1],
          f"slot_post's rebuild predicate equals plain at {where}")
    check(counts[-1][0] > 0 and risky[0] > 0,
          f"the audit and the rebuild predicate fired at {where}")

    a, b = blocks
    rp = ps._call_density(a.feat, addr, sg, params, c["jb"])
    f = ps._call_force(a.feat, rp, addr, sg, params, c["jb"])
    calls = {
        "slot_pre": (
            lambda: slot_pass.slot_pre(a, a.xs, a.vs, a.acc, movb,
                                       addr.gcounts, addr.n_occ, dt, True,
                                       True, False),
            lambda: slot_pass.slot_pre_plain(b, b.xs, b.vs, b.acc, movb,
                                             addr.gcounts, addr.n_occ, dt,
                                             True, True, False)),
        "slot_post": (   # a block's last, with the rebuild predicate
            lambda: slot_pass.slot_post(a, rp, f, c["x0s"], movb, addr,
                                        plan, step0, 0, True),
            lambda: slot_pass.slot_post_plain(b, rp, f, c["x0s"], movb,
                                              addr, plan, step0, 0, True)),
    }
    res = {}
    for kname, (kern, plain) in calls.items():
        b_ms, b_by = slot_pass_bound(kname, addr, movb, d, params)
        res[kname] = {"max_abs_err": err[kname], "bitwise_plain": True,
                      "ms": cuda_ms(kern), "graph_ms": graph_ms(kern),
                      "plain_ms": cuda_ms(plain), "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None}
    first = slot_pass.SlotBlock(sg.c_rows, sg.lanes, d, False, dev)
    res["slot_pre"]["first_ms"] = cuda_ms(lambda: slot_pass.slot_pre(
        first, xs, vs, acc, movb, addr.gcounts, addr.n_occ, dt, True, True,
        True))
    n = int(addr.n_occ[0])
    emit({"phase": "slot_pass", "preset": name, "lattice": lattice,
          "slot_arrays": [sg.c_rows, sg.lanes], "n_occ": n,
          "occupied_groups": int((addr.gcounts[1:n + 1, 0] > 0).sum()),
          "groups": sg.c_rows * sg.n_groups, "movable": int(movb.sum()),
          "ci_offset": ci, "faces": dataclasses.asdict(faces) if faces
          else None, "violations_kernel_plain": counts,
          "rebuild_risky_kernel_plain": risky,
          "kernels": res})
    return res


def cap8_lattice(scene, state):
    """(skin, GridSpec) of the cap-8 lattice the adaptive policy picks for
    `state`: the widest occupancy-fit skin (`step.cap8_skin`)."""
    from sph_tpu_torch import neighbors
    from sph_tpu_torch.step import cap8_skin

    skin = cap8_skin(scene, state, RESIDENT["sort_every"])
    check(skin is not None, "a cap-8 lattice fits the preset's step 0")
    return skin, neighbors.GridSpec.for_scene(scene, cap=8, skin=skin)


def timed_run(scene, state, n_steps: int, dev, **kw) -> float:
    """Host ms/step of run(...) ended by a synchronize (its notes dropped)."""
    from sph_tpu_torch import run

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        run(scene, n_steps, method="pallas", state=state, device=dev, **kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_steps * 1e3


def phase_cap8(name: str, dev) -> dict:
    """The cap-8 adaptive policy through `run` (one dispatch of at most 100
    steps, so that no remainder runs on the default cap) with the checks
    of phase 14; then in turns with resident4auto (resident, cap 8, cap 8,
    resident): host ms/step of the path, and device ms a step of one
    12-step dispatch (profile); and x of the two after 20 steps within
    1e-3 h."""
    from sph_tpu_torch import init, preset, run

    scene, n_steps = preset(name), DEPTH[name]
    spd = min(n_steps, 100)
    s0 = init(scene, device=dev)
    out = phase_path(name, scene, s0, n_steps, dev,
                     run_kw=dict(CAP8, steps_per_dispatch=spd),
                     rho_band=(0.90, 1.10))
    launches, pol = out["launches"], out["policy"]
    want = resident_launches(out, n_steps,
                             int(scene.params.integrator == "leapfrog"))
    check(launches["slot_density"] == launches["slot_force"] == want,
          f"K1/K2 launched {want} times on the cap-8 policy at {name}")
    check(launches["packed_density"] == launches["packed_force"]
          == launches["stage_transpose"] == 0,
          f"no K3/K4/K5 launch on the cap-8 policy at {name}")
    check(pol["modes"] in (["cap8"], ["cap16"])
          and pol["cap8_skins"][0] is not None,
          f"the cap-8 policy probed a lattice at {name}")
    host = {"resident4auto": [], "cap8": []}
    device = {"resident4auto": [], "cap8": []}
    order = ("resident4auto", "cap8", "cap8", "resident4auto")
    for key in order:
        kw = RESIDENT if key == "resident4auto" else CAP8
        host[key].append(timed_run(scene, s0, n_steps, dev,
                                   steps_per_dispatch=spd, **kw))
    for key in order:
        policy = {} if key == "resident4auto" else {"adaptive_cap": True}
        device[key].append(phase_profile_resident(name, scene, s0, 12, dev,
                                                  **policy))
    with contextlib.redirect_stderr(io.StringIO()):
        a = run(scene, 20, method="pallas", state=s0, device=dev,
                steps_per_dispatch=20, **CAP8)
        b = run(scene, 20, method="pallas", state=s0, device=dev,
                steps_per_dispatch=20, **RESIDENT)
    act = a.active
    same_active = bool(torch.equal(act, b.active))
    dx = float((a.x[act] - b.x[act]).abs().max())
    limit = 1e-3 * scene.params.h
    emit({"phase": "cap8", "preset": name, "steps": n_steps,
          "steps_per_dispatch": spd, "skin": pol["cap8_skins"][0],
          "mode": pol["modes"][-1], "healed": pol["healed"],
          "rebuilds": pol["rebuilds"], "repaired": pol["repaired"],
          "host_ms_per_step": host,
          "host_ms_per_step_note": "host clock over run(), prime included, "
                                   "in turns (resident, cap 8, cap 8, "
                                   "resident)",
          "device_ms_per_step": device,
          "agreement": {"steps": 20, "a": "cap 8", "b": "resident4auto",
                        "max_abs_dx": dx, "limit": limit,
                        "same_active": same_active,
                        "bitwise": {f: bool(torch.equal(getattr(a, f),
                                                        getattr(b, f)))
                                    for f in ("x", "v", "rho")}}})
    check(same_active and dx < limit,
          f"cap 8 vs resident4auto x within 1e-3 h at {name}")
    return out


def phase_cap8_switch(dev, spd: int = 8, max_dispatches: int = 10):
    """A jet outgrows cap 8 on the card: dam3d_100k's block at 2000 along x
    (the reference's jet, tests/test_pallas_equiv.py:447-490), run by the
    cap-8 policy until it switches.  With two blocks a dispatch the policy
    switches only when both heal (more than max(1, blocks // 8)), so the
    switching dispatch is the exact per-step re-run of both blocks and
    equals bitwise the per-step path from the same state; one more
    dispatch runs on the default cap."""
    from sph_tpu_torch import init, make_advance, make_audited_advance
    from sph_tpu_torch import preset, prime

    base = preset("dam3d_100k")
    jet = base.replace(blocks=tuple(
        dataclasses.replace(b, velocity=(2000.0, 0.0, 0.0))
        for b in base.blocks))
    state = init(jet, device=dev)
    if jet.params.integrator == "leapfrog":
        state = prime(jet, state, "pallas", device=dev)
    adv = make_audited_advance(jet, "pallas", spd, device=dev, **CAP8)
    notes = io.StringIO()
    reset_counts()
    healed = []
    for _ in range(max_dispatches):
        before, start = state, int(state.step)
        with contextlib.redirect_stderr(notes):
            state = adv(before)
        healed.append(adv.healed - sum(healed))
        if adv.mode != "cap8":
            break
    launches = read_counts("the cap-8 switch")
    check(adv.mode == "cap16", "the jet switches cap 8 -> the default cap")
    exact = make_advance(jet, "pallas", steps_per_dispatch=spd,
                         device=dev)(before)
    same = all(bool(torch.equal(getattr(state, f), getattr(exact, f)))
               for f in ("x", "v", "acc", "rho", "p", "step"))
    with contextlib.redirect_stderr(notes):
        after = adv(state)
    torch.cuda.synchronize()
    emit({"phase": "cap8_switch", "preset": "dam3d_100k jet",
          "particles": int(state.n_active()), "steps_per_dispatch": spd,
          "skin": adv.skin, "switch_step": start,
          "healed_per_dispatch": healed, "mode": adv.mode,
          "bitwise_per_step": same, "launches": launches,
          "notes": notes.getvalue().strip().splitlines()})
    check(healed[-1] == spd // RESIDENT["sort_every"],
          "every block of the switching dispatch healed")
    check(same, "the switching dispatch equals the per-step path bitwise")
    check(adv.mode == "cap16" and int(after.step) == start + 2 * spd
          and bool(torch.isfinite(after.x).all()),
          "the next dispatch runs on the default cap")


def phase_grid(name: str, n_steps: int, dev) -> None:
    """method="grid" (cell tiles in plain PyTorch, no kernel of its own;
    the reference's is XLA code): health, no hand-written kernel launched,
    host ms/step and peak memory; then 10 steps against method="pallas"
    per step: x within 1e-3 h."""
    from sph_tpu_torch import init, neighbors, preset, run

    scene = preset(name)
    s0 = init(scene, device=dev)
    grid = neighbors.GridSpec.for_scene(scene)

    def dropped(st) -> int:
        return max(int(neighbors.cell_overflow(st.x, st.active, grid)), 0)

    n_start, over = int(s0.n_active()), dropped(s0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = run(scene, n_steps, method="grid", state=s0, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(f"{name} grid")
    peak = torch.cuda.max_memory_allocated()
    over = max(over, dropped(out))
    hl = health(out, scene)
    a = run(scene, 10, method="grid", state=s0, device=dev)
    b = run(scene, 10, method="pallas", state=s0, device=dev)
    act = a.active
    dx = float((a.x[act] - b.x[act]).abs().max())
    limit = 1e-3 * scene.params.h
    emit({"phase": "path", "preset": name, "method": "grid",
          "steps": n_steps, **hl, "particles_at_start": n_start,
          "ms_per_step": wall / n_steps * 1e3,
          "ms_per_step_note": "host clock over run(), prime included; "
                              "plain PyTorch, no hand-written kernel",
          "peak_bytes": peak, "cell_overflow": over, "launches": launches,
          "agreement": {"steps": 10, "b": "pallas per step",
                        "max_abs_dx": dx, "limit": limit}})
    check_health(f"{name} grid", hl, n_start, over, (0.90, 1.10))
    check(not any(launches.values()),
          f"the grid method launches no hand-written kernel at {name}")
    check(bool(torch.equal(act, b.active)) and dx < limit,
          f"grid vs pallas x within 1e-3 h at {name}")


def png_chunks(data: bytes) -> list:
    """[(tag, payload)] of a PNG, each chunk's CRC checked."""
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    out, pos = [], 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        check(zlib.crc32(tag + payload) & 0xFFFFFFFF == crc, "PNG chunk CRC")
        out.append((tag, payload))
        pos += 12 + n
    return out


def decode_png(data: bytes) -> tuple[int, int]:
    """(width, height) of an RGB8 PNG whose pixel rows inflate whole."""
    chunks = png_chunks(data)
    w, h, depth, color = struct.unpack(">IIBB", chunks[0][1][:10])
    raw = zlib.decompress(b"".join(p for t, p in chunks if t == b"IDAT"))
    check(chunks[0][0] == b"IHDR" and (depth, color) == (8, 2)
          and len(raw) == h * (1 + 3 * w), "an RGB8 PNG that decodes")
    return w, h


def run_cli(argv: list, env=None, module: str = "cli",
            timeout: int = 600) -> tuple:
    """(returncode, stdout, stderr, seconds) of `python -m
    sph_tpu_torch.<module> argv` from the checkout's root."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"sph_tpu_torch.{module}",
                          *argv], cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout, env=env)
    return (res.returncode, res.stdout, res.stderr,
            time.perf_counter() - t0)


def phase_cli() -> None:
    """The user's entry point, `python -m sph_tpu_torch.cli`, in
    subprocesses on the card (the default --device cuda): run at
    dam3d_100k (--method auto, frames rendered), at splash3d_1m with
    --adaptive-cap, from the settled emitters3d checkpoint, --debug at
    dam2d_10k; record at dam2d_10k (an APNG through the native encoder);
    a contradictory flag set (exit 2, one line); and with the card hidden
    (exit 1, one line).  Any other outcome fails the phase."""
    import os
    import tempfile

    from sph_tpu_torch.diagnostics import SCALARS

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def go(argv, want_rc=0, env=None):
            rc, out, err, secs = run_cli(argv, env)
            emit({"phase": "cli", "argv": argv, "rc": rc, "seconds": secs,
                  "stdout_tail": out[-400:], "stderr_tail": err[-800:]})
            check(rc == want_rc, f"cli {' '.join(argv)} exits {want_rc}")
            return err

        def metrics(out: Path, frames: int, step: int, modes) -> list:
            recs = [json.loads(ln) for ln in
                    (out / "metrics.jsonl").read_text().splitlines()]
            keys = set(SCALARS) | {"frame", "step", "wall_s"}
            for r in recs:
                check(keys <= set(r) and all(
                    isinstance(r[k], (int, float)) and r[k] == r[k]
                    and abs(r[k]) != float("inf") for k in SCALARS),
                    f"finite metrics in {out.name}")
                check(r.get("cap_dropped", 0) == 0
                      and r.get("row_overflow", 0) == 0,
                      f"no cap overflow in {out.name}")
                check(modes is None or r.get("advance_mode") in modes,
                      f"advance_mode of {out.name}")
            check(len(recs) == frames and recs[-1]["step"] == step,
                  f"{frames} frames to step {step} in {out.name}")
            emit({"phase": "cli", "metrics": out.name, "last": recs[-1]})
            return recs

        dam = tmp / "dam3d_100k"
        go(["run", "dam3d_100k", "--frames", "3", "--steps-per-frame", "40",
            "--render", "--out", str(dam), "--quiet"])
        metrics(dam, 3, 120, ("resident",))
        sizes = [decode_png((dam / f"frame_{k:05d}.png").read_bytes())
                 for k in range(3)]
        check(sizes == [(400, 300)] * 3, "three 400x300 frames that decode")
        splash = tmp / "splash3d_1m"
        go(["run", "splash3d_1m", "--adaptive-cap", "--frames", "2",
            "--steps-per-frame", "20", "--out", str(splash), "--quiet"])
        metrics(splash, 2, 40, ("cap8", "cap16"))
        em = tmp / "emitters3d"
        go(["run", "emitters3d", "--resume", str(SETTLED), "--frames", "2",
            "--steps-per-frame", "100", "--out", str(em), "--quiet"])
        metrics(em, 2, 260200, ("packed", "slot"))
        dbg = tmp / "dam2d_10k"
        go(["run", "dam2d_10k", "--debug", "--frames", "1", "--out",
            str(dbg), "--quiet"])
        metrics(dbg, 1, 100, None)
        movie = tmp / "movie.apng"
        go(["record", "dam2d_10k", "--frames", "10", "--out", str(movie),
            "--quiet"])
        chunks = png_chunks(movie.read_bytes())
        actl = [p for t, p in chunks if t == b"acTL"]
        check(len(actl) == 1 and struct.unpack(">I", actl[0][:4])[0] == 10
              and sum(t == b"fcTL" for t, _ in chunks) == 10
              and not list(tmp.glob("movie_*.png")),
              "record wrote a 10-frame APNG through the native encoder")
        err = go(["run", "dam3d_100k", "--method", "pallas",
                  "--adaptive-cap"], want_rc=2)
        check(len(err.strip().splitlines()) == 1 and "Traceback" not in err,
              "a contradictory flag set is one line of usage error")
        err = go(["run", "dam2d_10k", "--frames", "1", "--out",
                  str(tmp / "nocard")], want_rc=1,
                 env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        check(len(err.strip().splitlines()) == 1 and "no CUDA device" in err
              and not (tmp / "nocard").exists(),
              "with no card the command stops with one line")


def torchrun_cli(nproc: int, argv: list) -> tuple:
    """(returncode, stdout, stderr, seconds) of `python -m
    torch.distributed.run --standalone --nproc-per-node nproc -m
    sph_tpu_torch.cli argv` from the checkout's root (its rendezvous on a
    free port of localhost)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "sph_tpu_torch.cli", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    return (res.returncode, res.stdout, res.stderr,
            time.perf_counter() - t0)


# the keys the decomposed loop writes a frame, as the reference's
# (sph_tpu/cli.py:376-392): the single-device keys without the static-cap
# audit (cap_dropped, row_overflow) and the CFL flag, plus shards (and
# mesh for pencils)
DECOMP_KEYS = {"frame", "step", "shards", "wall_s", "advance_mode",
               "healed_blocks", "repaired_blocks"}


def phase_cli_shards() -> None:
    """Phase 42, the command line's --shards under torchrun on the card:
    run dam3d_100k --shards 1 on one process (--method auto: the slab fast
    path over NCCL, frames rendered); run dam3d_100k --shards 2x2 on four
    processes on cuda:0 (gloo: pencils, the pencil note, mesh "2x2", one
    metrics.jsonl from rank 0); record dam2d_10k --shards 2 on two
    processes on cuda:0 (one APNG that decodes); run dam2d_10k --shards 1x1
    as a plain command (a one-rank NCCL group of its own); and --shards
    2x2 as one process (exit 2, one line naming torchrun)."""
    import tempfile

    from sph_tpu_torch.diagnostics import SCALARS

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        def go(nproc, argv):
            rc, out, err, secs = torchrun_cli(nproc, argv)
            emit({"phase": "cli_shards", "nproc": nproc, "argv": argv,
                  "rc": rc, "seconds": secs, "stdout_tail": out[-400:],
                  "stderr_tail": err[-1200:]})
            check(rc == 0, f"torchrun --nproc-per-node {nproc} "
                           f"{' '.join(argv)}: every process exits 0")
            return out, err

        def metrics(out: Path, frames: int, step: int, keys: set) -> list:
            recs = [json.loads(ln) for ln in
                    (out / "metrics.jsonl").read_text().splitlines()]
            for r in recs:
                check(set(r) == set(SCALARS) | keys and all(
                    r[k] == r[k] and abs(r[k]) != float("inf")
                    for k in SCALARS), f"the reference's keys, finite, in "
                                       f"{out.name}")
            check(len(recs) == frames and recs[-1]["step"] == step,
                  f"one line a frame to step {step} in {out.name}")
            emit({"phase": "cli_shards", "metrics": out.name,
                  "last": recs[-1]})
            return recs

        slab = tmp / "slab"
        _, err = go(1, ["run", "dam3d_100k", "--shards", "1", "--frames",
                        "3", "--steps-per-frame", "40", "--render", "--out",
                        str(slab), "--quiet"])
        check("nccl backend" in err, "--shards 1 on the card runs NCCL")
        recs = metrics(slab, 3, 120, DECOMP_KEYS)
        check(all(r["shards"] == 1 and r["advance_mode"] == "resident"
                  for r in recs), "the slab fast path on one rank")
        sizes = [decode_png((slab / f"frame_{k:05d}.png").read_bytes())
                 for k in range(3)]
        check(sizes == [(400, 300)] * 3, "three 400x300 frames that decode")
        pencil = tmp / "pencil"
        _, err = go(4, ["run", "dam3d_100k", "--shards", "2x2", "--device",
                        "cuda:0", "--frames", "2", "--steps-per-frame",
                        "20", "--out", str(pencil), "--quiet"])
        check(err.count("note: pencil decomposition steps per-step") == 1
              and err.count("gloo backend") == 1,
              "the pencil note and the backend line once, from rank 0")
        recs = metrics(pencil, 2, 40, {"frame", "step", "shards", "mesh",
                                       "wall_s"})
        check(all(r["mesh"] == "2x2" and r["shards"] == 4 for r in recs),
              "mesh 2x2 on four ranks")
        check(sorted(p.name for p in pencil.iterdir()) == ["metrics.jsonl"],
              "rank 0 alone writes, one metrics.jsonl")
        movie = tmp / "movie.apng"
        out, _ = go(2, ["record", "dam2d_10k", "--shards", "2", "--device",
                        "cuda:0", "--frames", "4", "--steps-per-frame",
                        "20", "--out", str(movie), "--quiet"])
        chunks = png_chunks(movie.read_bytes())
        actl = [p for t, p in chunks if t == b"acTL"]
        check(len(actl) == 1 and struct.unpack(">I", actl[0][:4])[0] == 4
              and sum(t == b"fcTL" for t, _ in chunks) == 4
              and out.count("wrote") == 1,
              "record --shards 2 wrote one 4-frame APNG, from rank 0")
        # --shards 1x1 as a plain command: a one-rank group of its own
        one = tmp / "one"
        rc, _, err, secs = run_cli(["run", "dam2d_10k", "--shards", "1x1",
                                    "--frames", "1", "--steps-per-frame",
                                    "10", "--out", str(one), "--quiet"])
        emit({"phase": "cli_shards", "argv": ["run", "dam2d_10k",
                                              "--shards", "1x1"],
              "rc": rc, "seconds": secs, "stderr_tail": err[-800:]})
        check(rc == 0 and "nccl backend" in err,
              "--shards 1x1 without torchrun runs in a one-rank NCCL group")
        metrics(one, 1, 10, {"frame", "step", "shards", "mesh", "wall_s"})
        rc, _, err, secs = run_cli(["run", "dam2d_10k", "--shards", "2x2",
                                    "--out", str(tmp / "none")])
        emit({"phase": "cli_shards", "argv": ["run", "dam2d_10k",
                                              "--shards", "2x2"],
              "rc": rc, "seconds": secs, "stderr_tail": err[-400:]})
        check(rc == 2 and len(err.strip().splitlines()) == 1
              and "torchrun --nproc-per-node 4" in err
              and not (tmp / "none").exists(),
              "--shards 2x2 as one process is one line of usage error")


def phase_cli_frames() -> None:
    """Phase 43, the reference CLI's frame split on the card: run
    dam2d_10k --steps-per-frame 250 (--method auto: 3 dispatches of 84
    steps) and --method pallas --steps-per-frame 101 (2 of 51), two
    frames each; metrics.jsonl's step must read 252, 504 and 102, 204."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for flags, want in ((["--steps-per-frame", "250"], [252, 504]),
                            (["--method", "pallas", "--steps-per-frame",
                              "101"], [102, 204])):
            out = Path(tmp) / "-".join(flags)
            argv = ["run", "dam2d_10k", "--frames", "2", *flags, "--out",
                    str(out), "--quiet"]
            rc, _, err, secs = run_cli(argv)
            steps = ([json.loads(ln)["step"] for ln in
                      (out / "metrics.jsonl").read_text().splitlines()]
                     if rc == 0 else None)
            emit({"phase": "cli_frames", "argv": argv, "rc": rc,
                  "seconds": secs, "steps": steps,
                  "stderr_tail": err[-800:]})
            check(rc == 0 and steps == want,
                  f"run {' '.join(flags)}: steps {want} as the reference")


# steps a dispatch of the bench table here (the bench's default is 100): a
# cut of depth only, every row at its preset's full size.  A row runs at
# most (2 + 3 * 64) dispatches (a chain holds at most 64), so at 8 steps
# no row gets past step 1,552 of its run.  The phase checks that this is
# short of the step where dam2d_10k's flow first outruns the skin of the
# classic resident4 row, which then raises, as the reference's row does
# (its clean-path rule): how far a row gets at the default 100 steps
# follows the card's speed.
BENCH_STEPS = 8
BENCH_MAX_DISPATCHES = 2 + 3 * 64


def first_violation(dev, name: str = "dam2d_10k", spd: int = 100,
                    dispatches: int = 40):
    """The step at the end of the first dispatch in which the classic
    resident4 row's advance (`make_advance(..., sort_every=4,
    slot_resident=True)`, dispatches of `spd`) reports a skin or cap
    violation, from the preset's init; None if none in `dispatches`."""
    import sph_tpu_torch as sph

    scene = sph.preset(name)
    state = sph.init(scene, device=dev)
    if scene.params.integrator == "leapfrog":
        state = sph.prime(scene, state, method="pallas", device=dev)
    adv = sph.make_advance(scene, "pallas", steps_per_dispatch=spd,
                           sort_every=4, slot_resident=True, device=dev)
    for _ in range(dispatches):
        state, viol = adv(state)
        if int(viol):
            return int(state.step)
    return None
BENCH_FLAGSHIP = ("splash3d_1m", "resident4auto")


def bench_table(text: str) -> tuple:
    """(tag → (n, ms/step, psteps/s) or the UNAVAILABLE text, the JSON
    list) of the bench's stdout."""
    lines = text.strip().splitlines()
    rows = {}
    for ln in lines[:-1]:
        tag, rest = ln.split(None, 1)
        m = re.match(r"n=\s*(\d+)\s+([\d.]+) ms/step\s+([\d.e+-]+) psteps/s",
                     rest)
        rows[tag] = ((int(m.group(1)), float(m.group(2)), float(m.group(3)))
                     if m else rest)
    return rows, json.loads(lines[-1])


def bench_expected_n(dev, spd: int) -> dict:
    """Scene → the active counts its rows may report: the seeded count for
    the scenes without emitters, and for splash3d_1m@settled its
    checkpoint's; for emitters3d, which starts empty, and
    emitters3d@settled, which goes on filling, the count emitted by some
    whole number of dispatches of `spd` steps from the start."""
    import sph_tpu_torch as sph
    from sph_tpu_torch import bench_step, make_settled_state as mss

    want = {}
    for name in sorted({n for n, _ in bench_step.CONFIGS}):
        if name.endswith("@settled"):
            state, scene = sph.load_checkpoint(
                mss.settled_path(name[: -len("@settled")]), device=dev)
        else:
            scene = sph.preset(name)
            state = sph.init(scene, device=dev)
        if scene.emitters:
            e, at = state.emit_step.cpu(), int(state.step)
            want[name] = {int((e <= at + k * spd).sum())
                          for k in range(1, 2 + 3 * 64 + 2)}
        else:
            want[name] = {int(state.n_active())}
    return want


def phase_bench(dev, smi: str) -> dict:
    """Phase 44, the bench subcommand on the card: `python -m
    sph_tpu_torch.cli bench --steps BENCH_STEPS` over the whole table in
    one subprocess (exit 0; every row present, the two @settled ones from
    the checkpoints phase 46 made, with n the active count: seeded, the
    settled checkpoint's, or for emitters3d and emitters3d@settled emitted
    by whole dispatches); each row's ms/step and particle-steps/s printed.
    First it finds where the
    classic resident4 row first raises at dam2d_10k (`first_violation`)
    and checks that no row here runs that far.  After the table, the
    flagship row in this process through `bench_step.bench_one`, its
    launches read: the staged K1/K2 ran and no yardstick did; the same for
    emitters3d@settled/resident4auto, on packed rows (K3/K4) where
    `packed_fits` says so at its checkpoint, else on slots (K1/K2); then
    `--assert-floor --only splash3d_1m/resident4auto` as a subprocess,
    which must exit 0."""
    from sph_tpu_torch import bench_step

    t0 = time.perf_counter()
    viol_at = first_violation(dev)
    emit({"phase": "bench", "dam2d_10k/resident4 first violation at step":
          viol_at, "most steps a row runs here":
          BENCH_MAX_DISPATCHES * BENCH_STEPS})
    # the violating block lies in the last dispatch of 100 steps
    check(viol_at is None
          or viol_at - 100 >= BENCH_MAX_DISPATCHES * BENCH_STEPS,
          "no row of this phase's table runs into dam2d_10k/resident4's "
          "first violation")
    argv = ["bench", "--steps", str(BENCH_STEPS)]
    rc, out, err, secs = run_cli(argv)
    emit({"phase": "bench", "argv": argv, "rc": rc, "seconds": secs,
          "nvidia_smi": smi, "stderr_tail": err[-800:]})
    check(rc == 0, "bench exits 0")
    rows, table = bench_table(out)
    want = bench_expected_n(dev, min(BENCH_STEPS, bench_step.BENCH_DISPATCH))
    for name, method in bench_step.CONFIGS:
        tag = f"{name}/{method}"
        row = rows.get(tag)
        check(isinstance(row, tuple), f"{tag} ran: {row}")
        n, ms, ps = row
        emit({"phase": "bench", "row": tag, "n": n, "ms_per_step": ms,
              "psteps_per_s": ps, "floor": bench_step.FLOORS.get(
                  (name, method)), "nvidia_smi": smi})
        check(n in want[name], f"{tag}: n={n} is the scene's active count")
    check([(r["config"], r["method"], r["n"]) for r in table]
          == [(t.split("/")[0], t.split("/")[1], rows[t][0])
              for t in rows if isinstance(rows[t], tuple)],
          "the JSON list holds every row that ran")

    name, method = BENCH_FLAGSHIP
    reset_counts()
    ps, per_step, n = bench_step.bench_one(name, method, BENCH_STEPS,
                                           device=dev)
    torch.cuda.synchronize()
    launches = read_counts(f"bench {name}/{method}")
    emit({"phase": "bench", "in_process": f"{name}/{method}", "n": n,
          "ms_per_step": per_step * 1e3, "psteps_per_s": ps,
          "launches": launches})
    check(n == 1_080_000, "the flagship row at full size")
    check(launches["slot_density"] > 0
          and launches["slot_density"] == launches["slot_force"],
          "the flagship row launched the staged K1 and K2")
    check(launches["packed_density"] == launches["stage_transpose"] == 0,
          "no K3 or K5 on the flagship row")
    check(bench_step.FLOORS[BENCH_FLAGSHIP],
          "the flagship row has an H100 floor")
    # the filled emitters3d row: packed rows where packed_fits says so at
    # its checkpoint (K3/K4), the slot layout where not (K1/K2)
    from sph_tpu_torch import load_checkpoint, make_settled_state as mss
    from sph_tpu_torch import packed_fits

    e_name = "emitters3d@settled"
    ckpt, scene_e = load_checkpoint(mss.settled_path("emitters3d"),
                                    device=dev)
    fits = packed_fits(scene_e, ckpt, RESIDENT["sort_every"])
    reset_counts()
    ps_e, per_step_e, n_e = bench_step.bench_one(e_name, method, BENCH_STEPS,
                                                 device=dev)
    torch.cuda.synchronize()
    e_launches = read_counts(f"bench {e_name}/{method}")
    layout = "packed rows (K3/K4)" if fits else "slot layout (K1/K2)"
    emit({"phase": "bench", "in_process": f"{e_name}/{method}", "n": n_e,
          "checkpoint_particles": int(ckpt.n_active()),
          "checkpoint_step": int(ckpt.step), "packed_fits": fits,
          "layout": layout, "ms_per_step": per_step_e * 1e3,
          "psteps_per_s": ps_e, "launches": e_launches})
    # the row's leapfrog prime is one per-step K1/K2 on either layout
    check(e_launches["packed_density"] > 0 and e_launches["slot_density"] == 1
          if fits else e_launches["packed_density"] == 0
          and e_launches["slot_density"] > 1,
          f"{e_name}/{method} runs on the {layout}, as packed_fits says")
    check(n_e in want[e_name], f"{e_name}: n={n_e} emitted from the "
          f"checkpoint by whole dispatches")

    argv = ["bench", "--steps", str(BENCH_STEPS), "--assert-floor",
            "--only", f"{name}/{method}"]
    rc, out, err, secs = run_cli(argv)
    emit({"phase": "bench", "argv": argv, "rc": rc, "seconds": secs,
          "stdout_tail": out[-600:], "stderr_tail": err[-400:]})
    check(rc == 0 and "REGRESSION" not in out,
          "the flagship row is above its floor")
    emit({"phase": "bench", "seconds": time.perf_counter() - t0})
    return {"launches": launches, "settled_launches": e_launches,
            "settled_layout": layout}


# ---------------------------------------------------------------------------
# The whole arc: the settled maker, the soaks, the cap-evidence tools
# ---------------------------------------------------------------------------

# the reference's depths (bench/soak_1m.py, soak_spatial.py,
# soak_emitters.py, measure_spill.py, bench_sweep.py defaults), but for
# emitters3d's soak: 260,000 steps do not fit the smoke's time, and its
# first 78,500 are the settled maker's emitters3d fill (the same advance
# from the same init), so the smoke runs its start
SOAK_1M_STEPS, SOAK_SPATIAL_STEPS, VORTEX_STEPS = 5000, 2000, 5000
EMITTERS_SOAK_STEPS, EMITTERS_FULL_STEPS = 10_000, 260_000
SPILL_ARGS, SWEEP_ARGS = ("dam3d_100k", 3000, 8), ("dam3d_100k", 50)
SOAK_OUT = ROOT / "out" / "soak_emitters3d.npz"     # gitignored


def soak_launches(launches: dict) -> dict:
    """The launch counts a soak reports beside the kernels' other paths."""
    return {k: launches[k] for k in ("slot_density", "slot_force", "slot_pre",
                                     "slot_post", "packed_density",
                                     "packed_force")}


def in_process(fn):
    """(fn()'s result, its stdout lines, its stderr notes) with the counts
    set to 0 just before and read just after, and the card synchronized."""
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn()
    torch.cuda.synchronize()
    return res, out.getvalue().splitlines(), err.getvalue().splitlines()


def phase_settled(dev, smi: str) -> dict:
    """`python -m sph_tpu_torch.make_settled_state CONFIG` for each config
    of its table, a subprocess each (exit 0), at the reference's criteria;
    then each checkpoint loaded and checked: splash3d_1m at step 3000 with
    every one of its 1,080,000 particles, finite, mean rho/rho0 in [0.90,
    1.10], max|v| < c0; emitters3d with at least 20,000 active at a step
    that is a multiple of 100, at most 120,000, finite.  Wall seconds of
    each process and ms a step by the maker's own clock."""
    from sph_tpu_torch import load_checkpoint
    from sph_tpu_torch import make_settled_state as mss
    from sph_tpu_torch.diagnostics import active_max_abs_v

    out = {}
    for config, (path, crit) in mss.SETTLED.items():
        rc, so, se, secs = run_cli([config], module="make_settled_state",
                                   timeout=900)
        lines = so.strip().splitlines()
        check(rc == 0, f"make_settled_state {config} exits 0: {se[-400:]}")
        prog = [re.search(r"step\s+(\d+)\s.*wall\s+([\d.]+)s", ln)
                for ln in lines]
        prog = [m for m in prog if m][-1]
        state, scene = load_checkpoint(path, device=dev)
        hl, step = health(state, scene), int(state.step)
        c0 = scene.params.sound_speed
        res = out[config] = {
            "phase": "settled", "config": config, "criteria": crit,
            "path": str(Path(path).relative_to(ROOT)), "rc": rc,
            "process_seconds": secs, "step": step, **hl,
            "max_abs_v": active_max_abs_v(state),
            "maker_ms_per_step": float(prog.group(2))
            / int(prog.group(1)) * 1e3,
            "maker_ms_per_step_note": "the maker's own wall clock at its "
                                      "last progress line, over its steps",
            "lines": lines[-3:], "nvidia_smi": smi}
        emit(res)
        check(hl["finite"], f"finite settled {config}")
        if "n_steps" in crit:
            check(step == crit["n_steps"]
                  and hl["particles"] == int(state.n_active()) == 1_080_000,
                  f"{config}: step 3000, every particle")
            check(0.90 <= hl["rho_mean_over_rest"] <= 1.10,
                  f"{config}: mean rho/rho0 settled")
            check(res["max_abs_v"] < c0, f"{config}: max|v| < c0")
        else:
            check(hl["particles"] >= crit["min_active"]
                  and step % 100 == 0 and step <= crit["max_steps"],
                  f"{config}: filled to min_active within max_steps")
    return out


def phase_soak_1m(dev, smi: str) -> dict:
    """`soak_1m.soak(5000)`, the flagship's whole arc on the production
    default with the cap-8 policy: the soak-average, healed, repaired,
    rebuilds, the step of the cap switch and the final mode, rho/rho0 and
    max|v| at the end, the peak memory; a healthy finish with every
    particle kept; the regime the reference recorded: the switch to the
    default cap early, heals in a minority of the blocks, repairs; K1/K2
    launched once a step, once for the prime and 4 more a healed block,
    slot_pre/slot_post once a step."""
    from sph_tpu_torch import preset, soak_1m

    scene, n = preset("splash3d_1m"), SOAK_1M_STEPS
    base = torch.cuda.memory_allocated()
    res, lines, notes = in_process(lambda: soak_1m.soak(n, device=dev))
    launches = read_counts("soak_1m")
    hl = health(res["state"], scene)
    # the first step of the dispatch that outgrew cap 8 (the policy's note)
    switch = next((s - soak_1m.SPD for s, m in res["modes"] if m != "cap8"),
                  None)
    blocks = n // RESIDENT["sort_every"]
    out = {"phase": "soak_1m", "steps": n,
           **{k: res[k] for k in ("n", "n_final", "timed_steps", "timed_s",
                                  "psteps_per_s", "ms_per_step", "healed",
                                  "repaired", "rebuilds", "mode", "modes",
                                  "max_abs_v", "peak_bytes")},
           "switch_step": switch, "rho_mean_over_rest": hl[
               "rho_mean_over_rest"], "max_speed": hl["max_speed"],
           "bytes_held_before": base, "launches": soak_launches(launches),
           "lines": lines, "notes": len(notes), "nvidia_smi": smi}
    emit(out)
    check(hl["finite"] and res["n_final"] == res["n"] == hl["particles"]
          == 1_080_000, "soak_1m: finite, every particle kept")
    check(0.90 <= hl["rho_mean_over_rest"] <= 1.10
          and res["max_abs_v"] < scene.params.sound_speed,
          "soak_1m: a healthy finish (rho/rho0 settled, max|v| < c0)")
    check(switch is not None and switch <= 1000 and res["mode"] == "cap16",
          "soak_1m: the cap-8 policy switches to the default cap early")
    check(0 < res["healed"] < blocks // 2 and res["repaired"] > 0,
          "soak_1m: heals in a minority of blocks, repairs")
    check(launches["slot_density"] == launches["slot_force"]
          == n + 1 + 4 * res["healed"] and launches["packed_density"] == 0,
          "soak_1m: K1/K2 once a step, the prime, 4 a healed block")
    check_slot_pass("soak_1m", launches, n, scene,
                    [m for _, m in res["modes"]])
    return out


def phase_soak_spatial(dev, smi: str) -> dict:
    """`soak_spatial.soak(2000, shards=1)` in a one-rank NCCL group of its
    own: every probe with all 1,080,000 particles, finite, the count of
    elastic recoveries and the host seconds a re-spec and re-shard of the
    final state take; K1/K2 (split, slab-local) launched once a step, once
    for the prime and 4 more a healed block when no recovery re-ran a
    dispatch."""
    from sph_tpu_torch import preset, soak_spatial
    from sph_tpu_torch.diagnostics import active_max_abs_v

    scene, n = preset("splash3d_1m"), SOAK_SPATIAL_STEPS
    res, lines, notes = in_process(
        lambda: soak_spatial.soak(n, 1, device=dev))
    launches = read_counts("soak_spatial")
    hl = health(res["state"], scene)
    # what an elastic recovery costs at 1 M besides its re-run: the
    # re-spec and re-shard of the gathered state on the host
    from sph_tpu_torch import comm, decomp, default_skin

    with comm.joined(comm.backend_for(dev), alone=True):
        t0 = time.perf_counter()
        spec = decomp.SpatialSpec.for_state(
            scene, res["state"], 1, skin=default_skin(scene, 4))
        decomp.spatial_shard_state(res["state"], scene, spec, dev)
        torch.cuda.synchronize()
        respec_s = time.perf_counter() - t0
    out = {"phase": "soak_spatial", "steps": n, "shards": 1,
           **{k: res[k] for k in ("n", "n_final", "timed_steps", "timed_s",
                                  "psteps_per_s", "ms_per_step",
                                  "recoveries", "healed", "repaired",
                                  "rebuilds", "mode", "probes",
                                  "peak_bytes")},
           "rho_mean_over_rest": hl["rho_mean_over_rest"],
           "max_abs_v": active_max_abs_v(res["state"]),
           "respec_reshard_s": respec_s,
           "launches": soak_launches(launches), "lines": lines,
           "notes": notes[-6:], "nvidia_smi": smi}
    emit(out)
    check(res["finite"] and hl["finite"], "soak_spatial: finite")
    check(len(res["probes"]) == n // 500 and all(
        p["n_act"] == res["n"] == 1_080_000 for p in res["probes"])
        and res["n_final"] == res["n"], "soak_spatial: n_act == n at every "
        "probe")
    check(not torch.distributed.is_initialized(),
          "soak_spatial: its group is gone with it")
    if not res["recoveries"]:
        check(launches["slot_density"] == launches["slot_force"]
              == n + 1 + 4 * res["healed"],
              "soak_spatial: K1/K2 once a step, the prime, 4 a healed block")
    check(launches["slot_post"] > 0, "soak_spatial: the resident passes ran")
    return out


def phase_soak_emitters(dev, smi: str) -> dict:
    """`soak_emitters.soak` of vortex2d at its 5000 steps (the constant-heal
    demotion the reference records: per step after two all-heal
    dispatches) and of emitters3d at EMITTERS_SOAK_STEPS (a cut, `reduced`)
    with its final state saved under out/: each finite with every
    particle kept, its mode changes, healed and repaired; K1/K2 once a step
    and 4 more a healed block (emitters3d's packed steps on K3/K4)."""
    from sph_tpu_torch import init, preset, soak_emitters

    out = {}
    SOAK_OUT.parent.mkdir(exist_ok=True)
    for config, n, save in (("vortex2d", VORTEX_STEPS, None),
                            ("emitters3d", EMITTERS_SOAK_STEPS, SOAK_OUT)):
        scene = preset(config)
        s0 = init(scene, device=dev)
        res, lines, notes = in_process(lambda: soak_emitters.soak(
            config, n, str(save) if save else None, device=dev))
        launches = read_counts(f"soak_emitters {config}")
        hl = health(res["state"], scene)
        want_n = int((s0.emit_step <= n).sum())
        primes = int(scene.params.integrator == "leapfrog")
        r = out[config] = {
            "phase": "soak_emitters", "config": config, "steps": n,
            **{k: res[k] for k in ("n_final", "timed_steps", "timed_s",
                                   "ms_per_step", "healed", "repaired",
                                   "rebuilds", "repair_k", "mode", "modes",
                                   "max_abs_v", "rho_mean", "peak_bytes")},
            "rho_mean_over_rest": res["rho_mean"] / scene.params.rest_density,
            "max_speed": hl["max_speed"], "launches": soak_launches(launches),
            "lines": lines, "notes": notes[-6:], "nvidia_smi": smi}
        if config == "emitters3d":
            r["saved"] = str(SOAK_OUT.relative_to(ROOT))
            r["reduced"] = {"steps": n, "of": EMITTERS_FULL_STEPS,
                            "why": "the smoke's time limit; the full soak "
                                   "runs outside the smoke"}
        emit(r)
        check(hl["finite"] and res["n_final"] == want_n == hl["particles"],
              f"soak_emitters {config}: finite, every emitted particle kept")
        slot_steps = launches["slot_density"] - primes - 4 * res["healed"]
        check(launches["slot_force"] == launches["slot_density"]
              and launches["packed_force"] == launches["packed_density"]
              and launches["packed_density"] + slot_steps == n,
              f"soak_emitters {config}: one layout a step, the prime, 4 a "
              f"healed block")
        if config == "vortex2d":
            check("perstep" in [m for _, m in res["modes"]],
                  "vortex2d: the constant-heal demotion to per step")
        else:
            check(SOAK_OUT.exists() and launches["packed_density"] > 0,
                  "emitters3d: packed rows ran, the state saved")
    return out


def phase_spill_sweep(dev, smi: str) -> dict:
    """`measure_spill` (dam3d_100k, 3000 steps, cap 8: its counts and
    WORST) and `bench_sweep` (dam3d_100k, 50 steps: caps 8, 16 and 32 each
    run, no FAIL), each with its launches; then K1/K2 on the cap-32 lattice
    of dam3d_100k's step 0 against their plain versions and bitwise their
    yardsticks (phase 3's checks, times, bound)."""
    from sph_tpu_torch import bench_sweep, measure_spill, neighbors, preset

    name, n_steps, cap = SPILL_ARGS
    res, lines, _ = in_process(
        lambda: measure_spill.measure(name, n_steps, cap, device=dev))
    launches = read_counts("measure_spill")
    spill = {"phase": "spill", "config": name, "steps": n_steps, "cap": cap,
             **{k: res[k] for k in ("worst_spilled", "worst_max_occ",
                                    "worst_spilled2")},
             "rows": res["rows"], "launches": soak_launches(launches),
             "lines": lines[-2:]}
    emit(spill)
    check(len(res["rows"]) == n_steps // 100 and lines[-1].startswith(
        "WORST over"), "measure_spill: a count a dispatch, the WORST line")
    check(launches["slot_density"] == launches["slot_force"] == n_steps + 1,
          "measure_spill: K1/K2 once a step and the prime")

    name, steps = SWEEP_ARGS
    rows, lines, _ = in_process(
        lambda: bench_sweep.sweep(name, steps, device=dev))
    launches = read_counts("bench_sweep")
    sweep = {"phase": "sweep", "config": name, "steps": steps,
             "rows": [{k: v for k, v in r.items() if k != "state"}
                      for r in rows],
             "launches": soak_launches(launches), "lines": lines,
             "nvidia_smi": smi}
    emit(sweep)
    check([r["cap"] for r in rows] == list(bench_sweep.CAPS)
          and not any("fail" in r for r in rows)
          and not any("FAIL" in ln for ln in lines),
          "bench_sweep: caps 8, 16 and 32 each run, no FAIL")
    check(all(bool(torch.isfinite(r["state"].x).all()) for r in rows),
          "bench_sweep: finite at every cap")
    check(launches["slot_density"] == launches["slot_force"]
          == len(rows) * (2 * steps + 1),
          "bench_sweep: K1/K2 once a step and the prime, at each cap")
    scene = preset(name)
    grid32 = neighbors.GridSpec.for_scene(scene, cap=32)
    at32 = phase_kernels(name, dev, grid=grid32, lattice="cap 32")
    return {"spill": spill, "sweep": sweep, "at_cap32": at32,
            "sweep_launches": launches}


# ---------------------------------------------------------------------------
# Domain decomposition (decomp.py on torch.distributed)
# ---------------------------------------------------------------------------

# steps each decomposed path is driven for
DECOMP_STEPS = {"dam3d_100k": 200, "splash3d_1m": 20}
RANKS, RANKS_STEPS = 4, 100
PENCIL_RANKS = (2, 2)     # the pencil grid of the four ranks
RANKS_FAST_SPD = 20       # the fast path's dispatches on the four ranks
# The fast path's mid-dispatch branches on the four ranks.  A dart in the
# dam3d_100k tank: one particle at 400 along z (0.64 a block, under skin/2
# = 0.72), in slab 1's interior, 1.96 before the lattice face at z = 34 ·
# 17.44, so that the membership predicate fires at its third block and it
# is repaired in place (every rank consents), then twice more as it
# crosses.  (An emitter in the tank would widen the skin to 4.32, and the
# cells of 20.32 overflow cap 16 at every build.)  And emitters3d@settled,
# whose 32 particles that activate at step 260,036 force a rebuild of
# every rank at the top of the second dispatch's last block.
DART_Z, DART_SPEED, EMIT_STEPS = 590.98, 400.0, 40


@contextlib.contextmanager
def process_group(backend: str, world: int, rank: int, store_dir):
    """A `world`-rank torch.distributed group through a file store in
    `store_dir` (no network port), destroyed on exit."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        backend, store=dist.FileStore(str(Path(store_dir) / "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def spec_builds(kind: str = "SpatialSpec"):
    """The SpatialSpec.for_state (or PencilSpec's) calls `run(shards=)`
    makes while the block runs: one a dispatch plan, one more per elastic
    re-spec."""
    from sph_tpu_torch import decomp

    cls = getattr(decomp, kind)
    made = []
    real = cls.for_state

    def spy(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    cls.for_state = staticmethod(spy)
    try:
        yield made
    finally:
        cls.for_state = staticmethod(real)


def agreement(a, b, n_start: int, same_order: bool) -> dict:
    """A decomposed run `a` against the single-device run `b`: exact
    conservation of the active count, and max |dx| over the position scale
    of b.  `same_order`: a's active slots are b's in the same order (one
    rank: no particle migrates), compared slot by slot; else by nearest
    neighbor, both ways (the symmetric Hausdorff distance of the two
    sets, exact differences in chunks), since slot order follows slab
    ownership and a sort by position is not stable under rounding."""
    xa, xb = a.x[a.active], b.x[b.active]
    n = [int(xa.shape[0]), int(xb.shape[0]), n_start]
    out = {"particles": n, "limit": 1e-4, "matched": "slot" if same_order
           else "nearest"}
    if len(set(n)) != 1:
        return {**out, "max_dx_over_scale": float("inf"), "bitwise": False}
    scale = float(xb.abs().max()) + 1e-6
    if same_order:
        dx = float((xa - xb).abs().max())
        bit = bool(torch.equal(xa, xb))
    else:
        dx = 0.0
        for p, q in ((xa, xb), (xb, xa)):
            for c in range(0, p.shape[0], 2048):
                d = torch.cdist(p[c:c + 2048], q,
                                compute_mode="donot_use_mm_for_euclid_dist")
                dx = max(dx, float(d.min(dim=1).values.max()))
        bit = dx == 0.0
    return {**out, "max_dx_over_scale": dx / scale, "bitwise": bit}


def check_agreement(name: str, agree: dict) -> None:
    check(len(set(agree["particles"])) == 1,
          f"exact conservation of the active count at {name}")
    check(agree["max_dx_over_scale"] < agree["limit"],
          f"decomposed vs single-device x within 1e-4 of scale at {name}")


def profiled(fn, n_steps: int) -> dict:
    """Device time per step of fn() (one call = n_steps steps) under
    torch.profiler, after one warm call: busy ms, share, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.device_time_total / 1e3 / n_steps, e.count / n_steps,
                    e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    return {"device_ms_per_step": busy,
            "wall_ms_per_step_profiled": wall / n_steps * 1e3,
            "device_busy_share": busy / (wall / n_steps * 1e3),
            "device_ops_per_step": sum(r[1] for r in rows),
            "top": [{"ms_per_step": ms, "per_step": c, "name": k[:90]}
                    for ms, c, k in rows[:10]]}


def phase_decomp_dp(dev) -> None:
    """The particle-DP step (world 1 over NCCL) at dam2d_10k for 10 steps,
    bitwise the port's naive step on the card; times of both."""
    from sph_tpu_torch import decomp, init, make_step, preset

    scene = preset("dam2d_10k")
    s0 = init(scene, device=dev)
    dp, naive = decomp.make_dp_step(scene), make_step(scene, "naive",
                                                      device=dev)
    loc, ref = decomp.shard_state(s0, dev), s0
    dp(loc), naive(ref)     # warm: the communicator, the cached constants
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        loc = dp(loc)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(10):
        ref = naive(ref)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = decomp.spatial_gather_state(loc)
    cap = ref.capacity
    same = {k: bool(torch.equal(getattr(out, k)[:cap], getattr(ref, k)))
            for k in ("x", "v", "acc", "rho", "p")}
    hl = health(out, scene)
    emit({"phase": "decomp_dp", "preset": "dam2d_10k", "world": 1,
          "backend": "nccl", "steps": 10, "capacity": cap,
          "bitwise_naive": same, **hl,
          "ms_per_step": (t1 - t0) / 10 * 1e3,
          "naive_ms_per_step": (t2 - t1) / 10 * 1e3,
          "ms_per_step_note": "host clock, ended by a synchronize"})
    check(all(same.values()), "the DP step is bitwise the naive step")
    check(hl["finite"], "finite DP state")


def phase_decomp_slab(name: str, dev) -> dict:
    """run(..., method="pallas", shards=1) over a one-rank NCCL world at
    full width: one dispatch, so one spec (no overflow, no re-spec); K1
    and K2 through the split API on the slab-local lattice; against the
    single-device per-step run: conservation, x within 1e-4 of scale;
    host ms/step of both in turns, device ms/step of both (profile), and
    what the split build, scatter_rp and a ghost compaction cost."""
    from sph_tpu_torch import decomp, init, make_advance, neighbors
    from sph_tpu_torch import pallas_step as ps, preset, prime, run

    scene, n_steps = preset(name), DECOMP_STEPS[name]
    s0 = init(scene, device=dev)
    n_start = int(s0.n_active())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with spec_builds() as specs:
        a = run(scene, n_steps, method="pallas", steps_per_dispatch=n_steps,
                shards=1, state=s0, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(f"decomp_slab {name}")
    b = run(scene, n_steps, method="pallas", state=s0, device=dev)
    agree = agreement(a, b, n_start, same_order=True)
    turns = {"single": [], "decomposed": []}
    for kind in ("single", "decomposed", "decomposed", "single"):
        shards = 1 if kind == "decomposed" else None
        turns[kind].append(timed_run(scene, s0, n_steps, dev, shards=shards))
    hl = health(a, scene)

    # device time per step: the decomposed step and the single-device one;
    # and the host time of run(shards=)'s set-up around the dispatches
    n_prof = 10 if name == "dam3d_100k" else 5
    sp = prime(scene, s0, "pallas", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spec = decomp.SpatialSpec.for_state(scene, sp, 1)
    t1 = time.perf_counter()
    loc = decomp.spatial_shard_state(sp, scene, spec, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    decomp.spatial_gather_state(loc)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    setup = {"for_state_ms": (t1 - t0) * 1e3, "shard_ms": (t2 - t1) * 1e3,
             "gather_ms": (t3 - t2) * 1e3}
    adv = decomp.make_spatial_advance(scene, spec, "pallas", n_prof)
    single = make_advance(scene, "pallas", steps_per_dispatch=n_prof,
                          device=dev)
    prof = {"decomposed": profiled(lambda: adv(loc), n_prof),
            "single": profiled(lambda: single(sp), n_prof)}
    # the pieces the slab step adds around K1/K2
    grid = neighbors.GridSpec.for_slab(scene, spec.slab_w, 0)
    ci = decomp._slab_geometry(scene, spec, grid, 0)[2]
    ghosts = torch.full((2 * spec.cap_ghost, scene.params.dim), 1e18,
                        device=dev)
    cx = torch.cat([sp.x, ghosts])
    cv = torch.cat([sp.v, torch.zeros_like(ghosts)])
    c_act = torch.cat([sp.active, torch.zeros(2 * spec.cap_ghost,
                                              dtype=torch.bool, device=dev)])
    ctx = ps.pallas_split_build(cx, cv, c_act, scene.params, grid, ci)
    rho_cc = torch.ones(cx.shape[0], device=dev)
    full = neighbors.GridSpec.for_scene(scene)
    sg = ps.slot_grid(full)
    pieces = {
        "split_build_ms": cuda_ms(lambda: ps.pallas_split_build(
            cx, cv, c_act, scene.params, grid, ci)),
        "single_build_and_scatter_ms": cuda_ms(lambda: ps.scatter_slots(
            ps.build_addr(sp.x, sp.active, full, sg),
            ps._pack_rows6(sp.x, sp.v), sg)),
        "scatter_rp_ms": cuda_ms(lambda: ps.scatter_rp(ctx.addr, rho_cc,
                                                       rho_cc, ctx.sg)),
        "ghost_compaction_ms": cuda_ms(lambda: decomp._ghost_buffer(
            sp.x, sp.v, *decomp._pack_idx(sp.active, spec.cap_ghost)[:2],
            scene.params.dim)),
    }
    out = {"phase": "decomp_slab", "preset": name, "world": 1,
           "backend": "nccl", "steps": n_steps,
           "spec": dataclasses.asdict(spec),
           "ci_offset": list(ci), "slab_grid": list(grid.shape),
           "full_grid": list(full.shape), "spec_builds": len(specs),
           **hl, "agreement": agree, "launches": launches,
           "ms_per_step": wall / n_steps * 1e3,
           "ms_per_step_turns": turns,
           "ms_per_step_median": {k: statistics.median(v)
                                  for k, v in turns.items()},
           "ms_per_step_note": "host clock over run(), prime included",
           "profile": prof, "pieces": pieces, "setup": setup}
    emit(out)
    check_health(f"decomp_slab {name}", hl, n_start, len(specs) - 1,
                 (0.90, 1.10))
    check_agreement(f"decomp_slab {name}", agree)
    for k in ("slot_density", "slot_force"):
        check(launches[k] == n_steps + 1,
              f"{k} launched {launches[k]} times on decomp_slab {name}")
    return out


def phase_decomp_pencil(name: str, dev) -> dict:
    """run(..., method="pallas", shards=(1, 1)) over the one-rank NCCL
    world at full width, one dispatch: a 1x1 pencil on the full lattice,
    every phase of the pencil step run once per axis with nothing to send.
    Health, one spec, K1/K2 launched n + 1 times; against the
    single-device per-step run slot by slot (the active count exactly, x
    within 1e-4 of scale) and, bit for bit or not, against the per-step
    run(shards=1) slabs; host ms/step in turns with those slabs, device ms
    and operations a step of a 12-step dispatch of each (profile)."""
    from sph_tpu_torch import decomp, init, preset, prime, run

    scene, n_steps = preset(name), DECOMP_STEPS[name]
    s0 = init(scene, device=dev)
    n_start = int(s0.n_active())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with spec_builds("PencilSpec") as specs:
        a = run(scene, n_steps, method="pallas", steps_per_dispatch=n_steps,
                shards=(1, 1), state=s0, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(f"decomp_pencil {name}")
    b = run(scene, n_steps, method="pallas", state=s0, device=dev)
    agree = agreement(a, b, n_start, same_order=True)
    c = run(scene, n_steps, method="pallas", steps_per_dispatch=n_steps,
            shards=1, state=s0, device=dev)
    vs_slabs = {k: bool(torch.equal(getattr(a, k), getattr(c, k)))
                for k in ("x", "v", "acc", "rho", "p", "emit_step")}
    hl = health(a, scene)
    kinds = {"per-step shards=1": dict(shards=1),
             "pencil shards=(1, 1)": dict(shards=(1, 1))}
    turns = {k: [] for k in kinds}
    for k in ("per-step shards=1", "pencil shards=(1, 1)",
              "pencil shards=(1, 1)", "per-step shards=1"):
        turns[k].append(timed_run(scene, s0, n_steps, dev,
                                  steps_per_dispatch=n_steps, **kinds[k]))
    n_prof = 12
    sp = prime(scene, s0, "pallas", device=dev)
    spec_p = decomp.PencilSpec.for_state(scene, sp, 1, 1)
    loc_p = decomp.pencil_shard_state(sp, scene, spec_p, dev)
    spec_s = decomp.SpatialSpec.for_state(scene, sp, 1)
    loc_s = decomp.spatial_shard_state(sp, scene, spec_s, dev)
    pencil = decomp.make_pencil_advance(scene, spec_p, "pallas", n_prof)
    slab = decomp.make_spatial_advance(scene, spec_s, "pallas", n_prof)
    prof = {"pencil shards=(1, 1)": profiled(lambda: pencil(loc_p), n_prof),
            "per-step shards=1": profiled(lambda: slab(loc_s), n_prof)}
    out = {"phase": "decomp_pencil", "preset": name, "world": 1,
           "backend": "nccl", "steps": n_steps,
           "spec": dataclasses.asdict(specs[0]), "spec_builds": len(specs),
           **hl, "agreement": agree, "launches": launches,
           "bitwise_per_step_slabs": vs_slabs,
           "ms_per_step": wall / n_steps * 1e3,
           "ms_per_step_turns": turns,
           "ms_per_step_median": {k: statistics.median(v)
                                  for k, v in turns.items()},
           "ms_per_step_note": "host clock over run(), prime included, in "
                               "turns (slabs, pencil, pencil, slabs)",
           "profile": prof}
    emit(out)
    check_health(f"decomp_pencil {name}", hl, n_start, len(specs) - 1,
                 (0.90, 1.10))
    check_agreement(f"decomp_pencil {name}", agree)
    for k in ("slot_density", "slot_force"):
        check(launches[k] == n_steps + 1,
              f"{k} launched {launches[k]} times on decomp_pencil {name}")
    return out


@contextlib.contextmanager
def audited_spatial():
    """The audited slab advances `run(shards=)` makes while the block runs
    (observation only: they carry the policy's counters and mode)."""
    from sph_tpu_torch import decomp

    made = []
    real = decomp.make_audited_spatial_advance

    def spy(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    decomp.make_audited_spatial_advance = spy
    try:
        yield made
    finally:
        decomp.make_audited_spatial_advance = real


def policy_of(made, blocks: int, fetches: dict) -> dict:
    """The counters of the audited slab advances `made`, per block."""
    pol = {k: sum(getattr(a, k) for a in made)
           for k in ("healed", "repaired", "rebuilds")}
    return {**pol, "modes": [a.mode for a in made], "blocks": blocks,
            "rebuilds_per_block": pol["rebuilds"] / blocks,
            "host_fetches": {**fetches, "per_block":
                             fetches["fetches"] / max(fetches["blocks"], 1)}}


def phase_decomp_fast(name: str, dev) -> dict:
    """The slab fast path, run(..., method="pallas", sort_every=4,
    slot_resident=True, shards=1), over the one-rank NCCL world at full
    width in one dispatch: health, no overflow (one spec), the policy's
    counters and host fetches per block, K1/K2 launched steps + prime + 4
    per healed block; against the single-device resident4auto run of the
    same plan slot by slot (the active count exactly, x within 1e-4 of the
    scale); host ms/step in turns with it and with the per-step
    run(shards=1); device ms and operations a step of one 12-step dispatch
    of each (profile)."""
    from sph_tpu_torch import decomp, default_skin, init
    from sph_tpu_torch import make_audited_advance, preset, prime, run
    from sph_tpu_torch import step as step_mod

    scene, n_steps = preset(name), DECOMP_STEPS[name]
    s0 = init(scene, device=dev)
    n_start = int(s0.n_active())
    primes = int(scene.params.integrator == "leapfrog")
    notes = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with spec_builds() as specs, audited_spatial() as made, \
            contextlib.redirect_stderr(notes):
        a = run(scene, n_steps, method="pallas", steps_per_dispatch=n_steps,
                shards=1, state=s0, device=dev, **RESIDENT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(f"decomp_fast {name}")
    pol = policy_of(made, n_steps // RESIDENT["sort_every"],
                    dict(step_mod.FETCHES))
    with contextlib.redirect_stderr(io.StringIO()):
        b = run(scene, n_steps, method="pallas", steps_per_dispatch=n_steps,
                state=s0, device=dev, **RESIDENT)
    agree = agreement(a, b, n_start, same_order=True)
    hl = health(a, scene)

    kinds = {"resident4auto": dict(RESIDENT),
             "fast shards=1": dict(RESIDENT, shards=1),
             "per-step shards=1": dict(shards=1)}
    turns = {k: [] for k in kinds}
    for k in ("resident4auto", "fast shards=1", "per-step shards=1",
              "per-step shards=1", "fast shards=1", "resident4auto"):
        turns[k].append(timed_run(scene, s0, n_steps, dev,
                                  steps_per_dispatch=n_steps, **kinds[k]))

    n_prof = 12
    sp = prime(scene, s0, "pallas", device=dev)
    skin = default_skin(scene, RESIDENT["sort_every"])
    spec_f = decomp.SpatialSpec.for_state(scene, sp, 1, skin=skin)
    loc_f = decomp.spatial_shard_state(sp, scene, spec_f, dev)
    spec_s = decomp.SpatialSpec.for_state(scene, sp, 1)
    loc_s = decomp.spatial_shard_state(sp, scene, spec_s, dev)
    fast = decomp.make_audited_spatial_advance(scene, spec_f, "pallas",
                                               n_prof, **RESIDENT)
    single = make_audited_advance(scene, "pallas", n_prof, device=dev,
                                  **RESIDENT)
    slab = decomp.make_spatial_advance(scene, spec_s, "pallas", n_prof)
    with contextlib.redirect_stderr(io.StringIO()):
        prof = {"fast shards=1": profiled(lambda: fast(loc_f), n_prof),
                "resident4auto": profiled(lambda: single(sp), n_prof),
                "per-step shards=1": profiled(lambda: slab(loc_s), n_prof)}
    out = {"phase": "decomp_fast", "preset": name, "world": 1,
           "backend": "nccl", "steps": n_steps, "run": dict(RESIDENT),
           "spec": dataclasses.asdict(specs[0]), "spec_builds": len(specs),
           **hl, "agreement": agree, "launches": launches, "policy": pol,
           "audit_notes": notes.getvalue().strip().splitlines(),
           "ms_per_step": wall / n_steps * 1e3,
           "ms_per_step_turns": turns,
           "ms_per_step_median": {k: statistics.median(v)
                                  for k, v in turns.items()},
           "ms_per_step_note": "host clock over run(), prime included, in "
                               "turns (resident, fast, per-step, per-step, "
                               "fast, resident)",
           "profile": prof}
    emit(out)
    check_health(f"decomp_fast {name}", hl, n_start, len(specs) - 1,
                 (0.90, 1.10))
    check_agreement(f"decomp_fast {name}", agree)
    want = n_steps + primes + 4 * pol["healed"]
    for k in ("slot_density", "slot_force"):
        check(launches[k] == want,
              f"{k} launched {launches[k]} times on decomp_fast {name} "
              f"(want {want})")
    check(pol["modes"] == ["resident"], f"the fast path ran at {name}")
    check_slot_pass(f"decomp_fast {name}", launches, n_steps, scene,
                    pol["modes"])
    return out


def phase_decomp_classic(dev) -> dict:
    """The classic fast-path form (slot_resident=False: pinned addressing
    and ghosts, a fresh scatter and the split K1/K2 each step) through
    make_audited_spatial_advance at dam3d_100k, one 200-step dispatch on
    the one-rank world: health, K1/K2 launched once a step (twice if the
    audit re-ran the dispatch per step), against the single-device
    non-resident reuse run slot by slot."""
    from sph_tpu_torch import decomp, default_skin, init, preset, prime, run

    name = "dam3d_100k"
    scene, n_steps = preset(name), DECOMP_STEPS[name]
    sp = prime(scene, init(scene, device=dev), "pallas", device=dev)
    n_start = int(sp.n_active())
    spec = decomp.SpatialSpec.for_state(scene, sp, 1,
                                        skin=default_skin(scene, 4))
    loc = decomp.spatial_shard_state(sp, scene, spec, dev)
    adv = decomp.make_audited_spatial_advance(scene, spec, "pallas", n_steps,
                                              sort_every=4)
    notes = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(notes):
        a = decomp.spatial_gather_state(adv(loc))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts("decomp_classic")
    reran = "re-ran exactly" in notes.getvalue()
    with contextlib.redirect_stderr(io.StringIO()):
        b = run(scene, n_steps, method="pallas", steps_per_dispatch=n_steps,
                sort_every=4, state=sp, device=dev)
    agree = agreement(a, b, n_start, same_order=True)
    hl = health(a, scene)
    emit({"phase": "decomp_classic", "preset": name, "world": 1,
          "steps": n_steps, "sort_every": 4, "slot_resident": False, **hl,
          "agreement": agree, "launches": launches, "reran": reran,
          "audit_notes": notes.getvalue().strip().splitlines(),
          "ms_per_step": wall / n_steps * 1e3,
          "ms_per_step_note": "host clock over the dispatch and the gather"})
    check_health("decomp_classic", hl, n_start, 0, (0.90, 1.10))
    check_agreement("decomp_classic", agree)
    want = n_steps * (2 if reran else 1)
    for k in ("slot_density", "slot_force"):
        check(launches[k] == want,
              f"{k} launched {launches[k]} times on decomp_classic")
    return {"launches": launches}


# the jet of the cap-8 switch phase, 8-step dispatches (2 blocks), at
# 8000 along x: at 2000 (3.2 a block on cells of 17.44) the block after a
# fresh build can keep every particle of the seeded lattice inside its
# build cell, which the membership-relaxed audit lets pass, and a
# demotion needs every block to heal
HEAL_SPD, HEAL_DISPATCHES, JET_SPEED = 8, 3, 8000.0


def jet_scene():
    from sph_tpu_torch import preset

    base = preset("dam3d_100k")
    return base.replace(blocks=tuple(
        dataclasses.replace(b, velocity=(JET_SPEED, 0.0, 0.0))
        for b in base.blocks))


def heal_sequence(dev) -> dict:
    """On this process group: the jet under make_audited_spatial_advance
    (slot-resident auto-rebuild, re-probing every 2 dispatches) for
    HEAL_DISPATCHES dispatches: the cumulative heals and the mode after
    each, the K1/K2 launches (4 steps a block on the fast attempt and 4 in
    its heal), the demotion notes; and whether the first dispatch, every
    block healed, is bitwise the per-step slab advance from its input."""
    from sph_tpu_torch import decomp, default_skin, init, prime
    from sph_tpu_torch import step as step_mod

    jet = jet_scene()
    state = prime(jet, init(jet, device=dev), "pallas", device=dev)
    spec = decomp.SpatialSpec.for_state(
        jet, state, decomp.comm.world_size(),
        skin=default_skin(jet, RESIDENT["sort_every"]))
    loc = decomp.spatial_shard_state(state, jet, spec, dev)
    saved = step_mod.PERSTEP_REPROBE_EVERY
    step_mod.PERSTEP_REPROBE_EVERY = 2
    notes = io.StringIO()
    try:
        adv = decomp.make_audited_spatial_advance(jet, spec, "pallas",
                                                  HEAL_SPD, **RESIDENT)
        torch.cuda.synchronize()
        reset_counts()
        healed, modes = [], []
        first = None
        with contextlib.redirect_stderr(notes):
            for _ in range(HEAL_DISPATCHES):
                before, loc = loc, adv(loc)
                first = first or (before, loc)
                healed.append(adv.healed)
                modes.append(adv.mode)
        torch.cuda.synchronize()
        launches = read_counts("decomp_heal")
    finally:
        step_mod.PERSTEP_REPROBE_EVERY = saved
    exact, worst = decomp.make_spatial_advance(jet, spec, "pallas",
                                               HEAL_SPD)(first[0])
    same = all(bool(torch.equal(getattr(first[1], f), getattr(exact, f)))
               for f in ("x", "v", "acc", "rho", "p", "emit_step", "step"))
    return {"healed": healed, "modes": modes,
            "launches": {k: launches[k] for k in ("slot_density",
                                                  "slot_force")},
            "bitwise_per_step": same, "per_step_worst": int(worst),
            "notes": notes.getvalue().strip().splitlines(),
            "finite": bool(torch.isfinite(loc.x).all())}


def check_heal(where: str, h: dict) -> None:
    blocks = HEAL_SPD // RESIDENT["sort_every"]
    check(h["healed"] == [blocks * (k + 1) for k in range(HEAL_DISPATCHES)],
          f"every block of every jet dispatch healed {where}")
    check(h["modes"] == ["resident", "perstep", "perstep"],
          f"the jet demotes after 2 dispatches and stays demoted on its "
          f"re-probe {where}")
    check(any("demoting to the per-step spatial path" in n
              for n in h["notes"]), f"the demotion note {where}")
    want = HEAL_DISPATCHES * blocks * 2 * RESIDENT["sort_every"]
    check(h["launches"]["slot_density"] == h["launches"]["slot_force"]
          == want, f"K1/K2 launched {want} times by the jet {where}")
    check(h["bitwise_per_step"] and h["per_step_worst"] == 0,
          f"a fully healed dispatch is bitwise the per-step slabs {where}")
    check(h["finite"], f"finite jet state {where}")


def phase_decomp_heal(dev) -> dict:
    """heal_sequence on the one-rank NCCL world (phase 38)."""
    h = heal_sequence(dev)
    emit({"phase": "decomp_heal", "preset": "dam3d_100k jet", "world": 1,
          "backend": "nccl", "steps_per_dispatch": HEAL_SPD, **h})
    check_heal("on one rank", h)
    return h


def decomp_rank_main(rank: int, world: int, tmp: str,
                     device: str = "cuda:0") -> int:
    """One of the RANKS processes of phase_decomp_ranks: run(shards=RANKS)
    on `device` over gloo, with a frame_callback; prints its numbers as one
    JSON line; rank 0 saves the gathered final state."""
    import numpy as np

    import sph_tpu_torch as sph
    from sph_tpu_torch import decomp

    dev = torch.device(device)
    offsets = []
    real = decomp._slab_geometry

    def spy(*args):
        offsets.append(real(*args)[2])
        return real(*args)

    decomp._slab_geometry = spy
    with process_group("gloo", world, rank, tmp):
        scene = sph.preset("dam3d_100k")
        frames = []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with spec_builds() as specs:
            out = sph.run(scene, RANKS_STEPS, method="pallas",
                          steps_per_dispatch=RANKS_STEPS // 2, shards=world,
                          device=dev,
                          frame_callback=lambda s: frames.append(int(s.step)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(f"decomp_ranks rank {rank}")
        if rank == 0:
            np.savez(Path(tmp) / "ranks.npz", **out.to_numpy())

        # the slab fast path, in dispatches of RANKS_FAST_SPD: the tank, the
        # tank with the dart, emitters3d@settled
        settled, scene_e = sph.load_checkpoint(str(SETTLED), device=dev)
        runs = {}
        for key, sc, st, n in (("fast", scene, None, RANKS_STEPS),
                               ("dart", dart_scene(), None, RANKS_STEPS),
                               ("emit", scene_e, settled, EMIT_STEPS)):
            out, runs[key] = fast_on_ranks(
                sph, sc, st, n, dev, world, f"decomp_ranks {key} rank {rank}")
            if rank == 0:
                np.savez(Path(tmp) / f"{key}.npz", **out.to_numpy())
        heal = heal_sequence(dev)
        pencil = pencil_on_ranks(sph, scene, dev, rank, tmp)
    emit({"rank": rank, "frames": frames, "launches": launches,
          "ci_offsets": sorted(set(map(tuple, offsets))),
          "spec_builds": len(specs), "cap_local": specs[0].cap_local,
          "ms_per_step": wall / RANKS_STEPS * 1e3, **runs, "heal": heal,
          "pencil": pencil})
    return 0


def pencil_on_ranks(sph, scene, dev, rank: int, tmp: str) -> dict:
    """Phase 41 on this rank: run(scene, RANKS_STEPS, method="pallas",
    shards=PENCIL_RANKS) in dispatches of RANKS_STEPS // 2 with a
    frame_callback; this rank's numbers (rank 0 saves the gathered
    state)."""
    import numpy as np

    from sph_tpu_torch import decomp

    lattices = []
    real = decomp._pencil_faces

    def spy(*args):
        faces, ci = real(*args)
        lattices.append({"ci_offset": list(ci), "shape": list(args[2].shape)})
        return faces, ci

    decomp._pencil_faces = spy
    frames = []
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with spec_builds("PencilSpec") as specs:
            out = sph.run(scene, RANKS_STEPS, method="pallas",
                          steps_per_dispatch=RANKS_STEPS // 2,
                          shards=PENCIL_RANKS, device=dev,
                          frame_callback=lambda s: frames.append(int(s.step)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        decomp._pencil_faces = real
    if rank == 0:
        np.savez(Path(tmp) / "pencil.npz", **out.to_numpy())
    return {"frames": frames, "spec_builds": len(specs),
            "spec": dataclasses.asdict(specs[0]),
            "launches": read_counts(f"decomp_pencil_ranks rank {rank}"),
            "lattices": lattices, "ms_per_step": wall / RANKS_STEPS * 1e3}


def dart_scene():
    from sph_tpu_torch import Block, calibrate, preset

    base = preset("dam3d_100k")
    dart = Block(lo=(299.0, 549.0, DART_Z - 1.0),
                 hi=(301.0, 551.0, DART_Z + 1.0),
                 velocity=(0.0, 0.0, DART_SPEED))
    return calibrate(base.replace(blocks=base.blocks + (dart,)))


def fast_on_ranks(sph, scene, state, n_steps: int, dev, world: int,
                  name: str) -> tuple:
    """run(scene, n_steps, state=state, shards=world) on the slab fast path
    in dispatches of RANKS_FAST_SPD: (state, this rank's numbers)."""
    frames = []
    notes = io.StringIO()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with spec_builds() as specs, audited_spatial() as made, \
            contextlib.redirect_stderr(notes):
        out = sph.run(scene, n_steps, method="pallas", state=state,
                      steps_per_dispatch=RANKS_FAST_SPD, shards=world,
                      device=dev, **RESIDENT,
                      frame_callback=lambda s: frames.append(int(s.step)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {"frames": frames, "spec_builds": len(specs),
                 "launches": read_counts(name),
                 "policy": policy_of(made, n_steps // 4,
                                     dict(sph.step.FETCHES)),
                 "notes": notes.getvalue().strip().splitlines(),
                 "ms_per_step": wall / n_steps * 1e3}


def phase_decomp_ranks(dev) -> dict:
    """RANKS processes on the one card (gloo, device cuda:0) run
    run(preset("dam3d_100k"), RANKS_STEPS, method="pallas",
    shards=RANKS) with a frame_callback: every rank launches K1/K2 once a
    step (+1 prime), ranks 1..RANKS-1 on a shifted lattice (ci_offset
    != 0), one spec (no overflow), frames after each dispatch; the
    gathered state against the single-device per-step run:
    conservation and x within 1e-4 of scale."""
    import tempfile

    import numpy as np

    from sph_tpu_torch import init, load_checkpoint, preset, run
    from sph_tpu_torch.state import State

    scene = preset("dam3d_100k")
    s0 = init(scene, device=dev)
    n_start = int(s0.n_active())
    b = run(scene, RANKS_STEPS, method="pallas", state=s0, device=dev)
    dscene = dart_scene()
    sd = init(dscene, device=dev)
    settled, scene_e = load_checkpoint(str(SETTLED), device=dev)
    # the active count at the end: the start's and the emissions due
    n_emit = int((settled.emit_step <= int(settled.step) + EMIT_STEPS).sum())
    check(n_emit > int(settled.n_active()),
          "an emission within the emitters3d@settled run")
    fast_kw = dict(method="pallas", device=dev,
                   steps_per_dispatch=RANKS_FAST_SPD, **RESIDENT)
    with contextlib.redirect_stderr(io.StringIO()):
        b_fast = run(scene, RANKS_STEPS, state=s0, **fast_kw)
        b_dart = run(dscene, RANKS_STEPS, state=sd, **fast_kw)
        b_emit = run(scene_e, EMIT_STEPS, state=settled, **fast_kw)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--decomp-rank",
             str(r), str(RANKS), tmp], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(RANKS)]
        res = []
        try:
            for proc in procs:
                o, e = proc.communicate(timeout=600)
                res.append((proc.returncode, o, e))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        for r, (rc, o, e) in enumerate(res):
            if rc != 0:
                sys.stderr.write(e[-4000:])
            check(rc == 0, f"decomp_ranks rank {r} exits 0")
        ranks = [json.loads(o.strip().splitlines()[-1]) for _, o, _ in res]
        a = State.from_numpy(dict(np.load(Path(tmp) / "ranks.npz")),
                             device=dev)
        a_fast = State.from_numpy(dict(np.load(Path(tmp) / "fast.npz")),
                                  device=dev)
        a_dart = State.from_numpy(dict(np.load(Path(tmp) / "dart.npz")),
                                  device=dev)
        a_emit = State.from_numpy(dict(np.load(Path(tmp) / "emit.npz")),
                                  device=dev)
        a_pencil = State.from_numpy(dict(np.load(Path(tmp) / "pencil.npz")),
                                    device=dev)
    agree = agreement(a, b, n_start, same_order=False)
    agree_fast = agreement(a_fast, b_fast, n_start, same_order=False)
    agree_dart = agreement(a_dart, b_dart, n_start + 1, same_order=False)
    agree_emit = agreement(a_emit, b_emit, n_emit, same_order=False)
    hl = health(a, scene)
    hl_fast = health(a_fast, scene)
    hl_dart = health(a_dart, dscene)
    hl_emit = health(a_emit, scene_e)
    emit({"phase": "decomp_ranks", "preset": "dam3d_100k", "world": RANKS,
          "backend": "gloo", "device": "cuda:0", "steps": RANKS_STEPS,
          "ranks": ranks, **hl, "agreement": agree,
          "fast": {"run": dict(RESIDENT,
                               steps_per_dispatch=RANKS_FAST_SPD),
                   **hl_fast, "agreement": agree_fast,
                   "against": "single-device resident4auto, the same "
                              "dispatches"},
          "dart": {"dart_z": DART_Z, "dart_speed": DART_SPEED, **hl_dart,
                   "agreement": agree_dart},
          "emit": {"preset": "emitters3d@settled", "steps": EMIT_STEPS,
                   **hl_emit, "agreement": agree_emit},
          "wall_s_all_ranks": wall,
          "note": "host ms/step of each rank, prime included; four "
                  "processes share one card and stage every exchange "
                  "through host memory (gloo)"})
    for r in ranks:
        check(r["frames"] == [RANKS_STEPS // 2, RANKS_STEPS],
              f"frame_callback after each dispatch on rank {r['rank']}")
        check(r["spec_builds"] == 1, f"no overflow on rank {r['rank']}")
        for k in ("slot_density", "slot_force"):
            check(r["launches"][k] == RANKS_STEPS + 1,
                  f"{k} launched {r['launches'][k]} times on rank "
                  f"{r['rank']}")
        if r["rank"] > 0:
            check(all(ci[0] != 0 for ci in r["ci_offsets"]),
                  f"a shifted lattice (ci_offset != 0) on rank {r['rank']}")
    check_health("decomp_ranks", hl, n_start, 0, (0.90, 1.10))
    check_agreement("decomp_ranks", agree)
    # the fast path: the counters are mesh-wide, so every rank's equal
    pol_keys = ("healed", "repaired", "rebuilds", "modes")
    # (steps, K1/K2 prime launches) of each fast-path run
    plan = {"fast": (RANKS_STEPS, 1), "dart": (RANKS_STEPS, 1),
            "emit": (EMIT_STEPS, 0)}
    for r in ranks:
        for run_name, (n, primes) in plan.items():
            f, f0 = r[run_name], ranks[0][run_name]
            where = f"the {run_name} run's fast path on rank {r['rank']}"
            check(f["frames"][-1] - f["frames"][0] == n - RANKS_FAST_SPD
                  and len(f["frames"]) == n // RANKS_FAST_SPD,
                  f"frames after each dispatch of {where}")
            check(f["spec_builds"] == 1, f"no overflow on {where}")
            check({k: f["policy"][k] for k in pol_keys}
                  == {k: f0["policy"][k] for k in pol_keys},
                  f"the counters of {where} equal rank 0's")
            want = n + primes + 4 * f["policy"]["healed"]
            for k in ("slot_density", "slot_force"):
                check(f["launches"][k] == want,
                      f"{k} launched {f['launches'][k]} times on {where} "
                      f"(want {want})")
        dp, ep = r["dart"]["policy"], r["emit"]["policy"]
        check(dp["repaired"] >= 1 and dp["healed"] == 0,
              f"the dart is repaired mid-dispatch, no heal, on rank "
              f"{r['rank']}")
        check(ep["rebuilds"] - ep["healed"] > EMIT_STEPS // RANKS_FAST_SPD,
              f"a rebuild besides the dispatch tops and heals (the "
              f"emission) on rank {r['rank']}")
        check_heal(f"on rank {r['rank']} of {RANKS}", r["heal"])
        check(r["heal"]["healed"] == ranks[0]["heal"]["healed"],
              f"the jet's heals of rank {r['rank']} equal rank 0's")
    check_health("decomp_ranks fast", hl_fast, n_start, 0, (0.90, 1.10))
    check_agreement("decomp_ranks fast", agree_fast)
    check_health("decomp_ranks dart", hl_dart, n_start + 1, 0, (0.90, 1.10))
    check_agreement("decomp_ranks dart", agree_dart)
    check_health("decomp_ranks emit", hl_emit, n_emit, 0,
                  vmax_limit=3.0 * scene_e.params.sound_speed)
    check_agreement("decomp_ranks emit", agree_emit)
    check_pencil_ranks(ranks, a_pencil, b, scene, n_start)
    return {"ranks": ranks, "agreement": agree, "agreement_fast": agree_fast,
            "agreement_dart": agree_dart, "agreement_emit": agree_emit}


def check_pencil_ranks(ranks: list, a, b, scene, n_start: int) -> None:
    """Phase 41: the 2x2 pencil run of the four rank processes: frames
    after each dispatch, one spec (the same on every rank), K1/K2
    launched RANKS_STEPS + 1 times a rank, each rank's lattice restricted
    on both cut axes and shifted on each axis where its grid coordinate is
    not 0; the gathered state's health and, against the single-device
    per-step run `b`, the active count exactly and x within 1e-4 of
    scale by nearest neighbor."""
    from sph_tpu_torch import neighbors

    agree = agreement(a, b, n_start, same_order=False)
    hl = health(a, scene)
    full = neighbors.GridSpec.for_scene(scene).shape
    per_rank = [{"rank": r["rank"], **r["pencil"]} for r in ranks]
    emit({"phase": "decomp_pencil_ranks", "preset": "dam3d_100k",
          "world": RANKS, "grid": list(PENCIL_RANKS), "backend": "gloo",
          "device": "cuda:0", "steps": RANKS_STEPS, "full_grid": list(full),
          "ranks": per_rank, **hl, "agreement": agree,
          "note": "host ms/step of each rank, prime included; four "
                  "processes share one card and stage every exchange "
                  "through host memory (gloo)"})
    for p in per_rank:
        where = f"pencil rank {p['rank']}"
        spec = p["spec"]
        check(p["frames"] == [RANKS_STEPS // 2, RANKS_STEPS],
              f"frame_callback after each dispatch on {where}")
        check(p["spec_builds"] == 1 and spec == per_rank[0]["spec"],
              f"one spec, the same on every rank, on {where}")
        for k in ("slot_density", "slot_force"):
            check(p["launches"][k] == RANKS_STEPS + 1,
                  f"{k} launched {p['launches'][k]} times on {where}")
        i = divmod(p["rank"], PENCIL_RANKS[1])
        for lat in p["lattices"]:
            for k, ax in enumerate((spec["axis1"], spec["axis2"])):
                check(lat["shape"][ax] < full[ax],
                      f"the lattice restricted on axis {ax} on {where}")
                check((lat["ci_offset"][ax] > 0) == (i[k] > 0),
                      f"the lattice shifted on axis {ax} iff the rank's "
                      f"coordinate is not 0, on {where}")
    check_health("decomp_pencil_ranks", hl, n_start, 0, (0.90, 1.10))
    check_agreement("decomp_pencil_ranks", agree)


def slab_rank1(dev, skin: float = 0.0):
    """Rank 1's slab-local lattice of a RANKS-slab dam3d_100k at step 0:
    (scene, s0, spec, grid, geometry (lo, hi, ci_offset) of ranks 0-2, its
    slots (x, v, active, global index), the ghosts both neighbors send
    (their faces' particles), the ghost band, the lattice's name).  With
    `skin`: the fast path's skinned slab lattice, its ghosts the
    auto-rebuild path's 2·(h + skin)-deep bands."""
    from sph_tpu_torch import decomp, init, neighbors, preset

    scene = preset("dam3d_100k")
    params = scene.params
    s0 = init(scene, device=dev)
    spec = decomp.SpatialSpec.for_state(scene, s0, RANKS, skin=skin)
    slabs = decomp.spatial_slabs(s0, spec)
    if skin:
        grid = neighbors.GridSpec.for_slab(
            scene, spec.slab_w, spec.axis,
            cap=neighbors.GridSpec.for_scene(scene).cap, skin=skin)
        band = 2.0 * (params.h + skin)
        lattice = "skinned slab-local (sort_every=4), rank 1 of 4"
    else:
        grid = neighbors.GridSpec.for_slab(scene, spec.slab_w, spec.axis)
        band = params.h
        lattice = "slab-local, rank 1 of 4"
    geo = [decomp._slab_geometry(scene, spec, grid, r, skin)
           for r in (0, 1, 2)]
    local = part_tensors(s0, slabs, decomp._slab_of(s0.x.cpu().numpy(),
                                                    spec), spec.cap_local,
                         dev)
    parts = []
    for r, face in ((0, "hi"), (2, "lo")):      # what ranks 0 and 2 send
        lo, hi = geo[r][0], geo[r][1]
        parts.append(face_ghosts(local(r), 0, lo, hi, face, band,
                                 spec.cap_ghost))
    return scene, s0, spec, grid, geo, local(1), parts, band, lattice


def phase_kernels_slab(dev, skin: float = 0.0) -> dict:
    """K1 and K2 on rank 1's slab-local lattice of a RANKS-slab
    dam3d_100k at step 0 (`slab_rank1`): the step's concatenation of
    locals and the ghosts both neighbors send, K2 on rp from scatter_rp
    with the ghosts' rho/p as their owners compute them (the single-device
    K1).  Bitwise their simple yardsticks, phase 3's tolerances against the
    plain versions, times and bound.  With `skin` (phase 37): the fast
    path's skinned slab lattice."""
    scene, s0, _, grid, geo, local, parts, band, lattice = slab_rank1(dev,
                                                                      skin)
    return kernels_on_lattice(dev, scene, s0, grid, geo[1][2], local,
                              parts, lattice, {"ghost_band": band})


def phase_kernels_pencil(dev) -> dict:
    """K1 and K2 on rank (1, 1)'s pencil-local lattice of a 2x2
    dam3d_100k at step 0 (`pc`): restricted along axes 0 and 2, with the
    ghosts of both phases, the axis-1 ghosts rank (0, 1) sends and the
    axis-2 ghosts rank (1, 0) sends from its locals and its own axis-1
    ghosts of rank (0, 0) (the corner, by two hops).  The checks, times and
    bound of phase 33."""
    from sph_tpu_torch import decomp, init, neighbors, preset

    scene = preset("dam3d_100k")
    h = scene.params.h
    s0 = init(scene, device=dev)
    spec = decomp.PencilSpec.for_state(scene, s0, *PENCIL_RANKS)
    a1, a2, cap = spec.axis1, spec.axis2, spec.cap_ghost
    grid = neighbors.GridSpec.for_pencil(scene, {a1: spec.w1, a2: spec.w2})
    local = part_tensors(
        s0, decomp.pencil_parts(s0, spec),
        decomp._pencil_of(s0.x.cpu().numpy(), a1, spec.lo1, spec.w1,
                          spec.n1, a2, spec.lo2, spec.w2, spec.n2),
        spec.cap_local, dev)
    # each pencil's faces (lo, hi, k_dev) along (axis 1, axis 2)
    faces = {r: [decomp._faces(scene, grid, ax, lo, w, i)
                 for ax, lo, w, i in zip((a1, a2), (spec.lo1, spec.lo2),
                                         (spec.w1, spec.w2),
                                         divmod(r, spec.n2))]
             for r in range(spec.n1 * spec.n2)}

    def hi_ghosts(src, r, k):
        return face_ghosts(src, (a1, a2)[k], *faces[r][k][:2], "hi", h, cap)

    def none():
        d = scene.params.dim
        return (torch.full((cap, d), 1e18, device=dev),
                torch.zeros((cap, d), device=dev),
                torch.zeros(cap, dtype=torch.bool, device=dev),
                torch.zeros(cap, dtype=torch.int64, device=dev))

    # rank (1, 0): its locals and the axis-1 ghosts rank (0, 0) sends
    g1_10 = hi_ghosts(local(0), 0, 0)
    comb_10 = tuple(torch.cat([a, b]) for a, b in zip(local(2), g1_10))
    g1 = hi_ghosts(local(1), 1, 0)          # from rank (0, 1)
    g2 = hi_ghosts(comb_10, 2, 1)           # from rank (1, 0), corners too
    # corner ghosts: the axis-2 ghosts that were (0, 0)'s axis-1 ghosts
    corner = int((g2[2] & torch.isin(g2[3], g1_10[3][g1_10[2]])).sum())
    check(corner > 0, "corner ghosts reach rank (1, 1) by two hops")
    ci = [0] * scene.params.dim
    ci[a1], ci[a2] = faces[3][0][2], faces[3][1][2]
    # the step's order: the axis-1 ghosts from the left and the right,
    # then the axis-2 ones (rank (1, 1) has no right neighbor on either)
    return kernels_on_lattice(
        dev, scene, s0, grid, tuple(ci), local(3), [g1, none(), g2, none()],
        "pencil-local (pc), rank (1, 1) of 2x2",
        {"ghost_band": h, "axes": [a1, a2], "corner_ghosts": corner})


def part_tensors(s0, parts, owner, cap_local: int, dev):
    """r → (x, v, active, global index) of part r's slots: its live
    particles in order (their indices in s0), then pads."""
    import numpy as np

    from sph_tpu_torch import decomp

    live = s0.emit_step.cpu().numpy() != int(decomp.INACTIVE)

    def tensors(r):
        gi = np.zeros(cap_local, np.int64)
        sel = np.nonzero(live & (owner == r))[0]
        gi[: len(sel)] = sel
        return (torch.as_tensor(parts[r]["x"], device=dev),
                torch.as_tensor(parts[r]["v"], device=dev),
                torch.as_tensor(parts[r]["emit_step"] <= 0, device=dev),
                torch.as_tensor(gi, device=dev))

    return tensors


def face_ghosts(src, axis: int, lo, hi, face: str, band: float,
                cap: int):
    """The ghosts a rank with slots `src` = (x, v, active, global index)
    sends across its `face` ("lo" or "hi") of `axis`: the active slots
    within `band` of it, compacted as the step compacts them (x 1e18, v
    0 and index 0 past the selection)."""
    import numpy as np

    from sph_tpu_torch import decomp

    x, v, act, gi = src
    near = act & ((x[:, axis] >= float(hi - np.float32(band)))
                  if face == "hi"
                  else (x[:, axis] < float(lo + np.float32(band))))
    idx, val, over = decomp._pack_idx(near, cap)
    check(int(over) == 0, "the ghost buffers hold the faces")
    return (torch.where(val[:, None], decomp._gather_rows(x, idx), 1e18),
            torch.where(val[:, None], decomp._gather_rows(v, idx), 0.0),
            val, torch.where(val, gi[torch.clamp(idx, max=x.shape[0] - 1)],
                             0))


def kernels_on_lattice(dev, scene, s0, grid, ci, local, parts,
                       lattice: str, extra: dict) -> dict:
    """K1 and K2 on a rank-local lattice (`grid`, `ci`) of dam3d_100k at
    step 0: the rank's slots `local` = (x, v, active, global index), then
    the ghost `parts` it received, each (x, v, valid, global index), K2
    on rp from scatter_rp with the ghosts' rho/p as their owners compute
    them (the single-device K1).  Bitwise their simple yardsticks, phase
    3's tolerances against the plain versions, the locals' rho against
    the single-device K1, times and bound."""
    from sph_tpu_torch import neighbors, pallas_step as ps
    from sph_tpu_torch import physics
    from sph_tpu_torch import slot_kernels as sk

    params = scene.params
    d = params.dim
    # the single-device rho/p: what each ghost's owner computes for it
    full = neighbors.GridSpec.for_scene(scene)
    rho_g, p_g, _ = ps.pallas_rho_p_f(s0.x, s0.v, s0.active, params, full)
    ghost_rp = [(torch.where(g[2], rho_g[g[3]], 1.0),
                 torch.where(g[2], p_g[g[3]], 0.0)) for g in parts]
    x1, v1, a1, gi1 = local
    cx = torch.cat([x1] + [g[0] for g in parts])
    cv = torch.cat([v1] + [g[1] for g in parts])
    c_act = torch.cat([a1] + [g[2] for g in parts])
    ctx = ps.pallas_split_build(cx, cv, c_act, params, grid, ci)
    sg, addr, feat = ctx.sg, ctx.addr, ctx.feat
    args = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params)
    where = f"dam3d_100k, {lattice} lattice"
    check(int(addr.overflow) == 0, f"no particle dropped at {where}")
    rp_k = sk.slot_density(feat, *args)
    rp_p = sk.density_plain(feat, *args)
    torch.cuda.synchronize()
    rho_k, ok = ps._gather_rho(rp_k, addr, sg, params)
    rho_p, _ = ps._gather_rho(rp_p, addr, sg, params)
    check(bool(torch.allclose(rho_k, rho_p, rtol=RHO_RTOL, atol=RHO_ATOL)),
          f"K1 vs plain at {where}")
    # the locals' rho is exact on the rank's lattice: it is the global one
    nl = x1.shape[0]
    check(bool(torch.allclose(rho_k[:nl][a1], rho_g[gi1][a1],
                              rtol=RHO_RTOL, atol=RHO_ATOL)),
          f"the locals' rank-local K1 rho vs the single-device K1 at "
          f"{where}")
    # K1's own EOS p (what the single-device K2 reads) against PyTorch's
    # EOS of K1's rho (what the slab step re-imports through scatter_rp)
    lane_p = (addr.row_pos.long() * 2 + 1) * sg.lanes + addr.pos.long()
    p_kern = rp_k.reshape(-1)[torch.where(ok, lane_p, 0)][ok]
    p_torch = physics.eos_pressure(rho_k, params)[ok]
    eos = {"eos": params.eos, "bitwise": bool(torch.equal(p_kern, p_torch)),
           "differ": int((p_kern != p_torch).sum()),
           "max_abs": float((p_kern - p_torch).abs().max()),
           "max_rel": float(((p_kern - p_torch).abs()
                             / p_torch.abs().clamp(min=1e-30)).max())}
    rho_cc = torch.cat([rho_k[:nl]] + [g[0] for g in ghost_rp])
    p_cc = torch.cat([physics.eos_pressure(rho_k[:nl], params)]
                     + [g[1] for g in ghost_rp])
    rp_s = ps.scatter_rp(addr, rho_cc, p_cc, sg)
    f_k = sk.slot_force(feat, rp_s, *args)
    f_p = sk.force_plain(feat, rp_s, *args)
    rp_simple = sk.slot_density_simple(feat, *args)
    f_simple = sk.slot_force_simple(feat, rp_s, *args)
    torch.cuda.synchronize()
    check(bitwise(rp_k, rp_simple), f"K1 bitwise its yardstick at {where}")
    check(bitwise(f_k, f_simple), f"K2 bitwise its yardstick at {where}")
    fk = ps._gather_f(f_k, addr, sg, d, ok)
    fp = ps._gather_f(f_p, addr, sg, d, ok)
    f_err = float(torch.max(torch.abs(fk - fp)))
    f_scale = float(torch.max(torch.abs(fp)))
    check(f_err / f_scale < F_REL, f"K2 vs plain at {where}")
    counts = pair_counts(feat, addr, sg, params)
    res = {}
    for name, kern, simple, plain, err in (
        ("slot_density", lambda: sk.slot_density(feat, *args),
         lambda: sk.slot_density_simple(feat, *args),
         lambda: sk.density_plain(feat, *args),
         float(torch.max(torch.abs(rho_k - rho_p)))),
        ("slot_force", lambda: sk.slot_force(feat, rp_s, *args),
         lambda: sk.slot_force_simple(feat, rp_s, *args),
         lambda: sk.force_plain(feat, rp_s, *args), f_err),
    ):
        b_ms, b_by = bound(name, feat, addr, sg, d, counts)
        res[name] = {"max_abs_err": err, "bitwise_simple": True,
                     **in_turns(kern, simple), "plain_ms": cuda_ms(plain),
                     "bound_ms": b_ms, "bound_by": b_by}
    emit({"phase": "kernels", "preset": "dam3d_100k",
          "lattice": lattice, **extra, "ci_offset": list(ci),
          "rank_grid": list(grid.shape), "full_grid": list(full.shape),
          "feat": list(feat.shape), "n_occ": int(addr.n_occ[0]),
          "particles": int(ok.sum()), "ghosts": int(sum(int(g[2].sum())
                                                         for g in parts)),
          "pairs": counts, "f_max_rel_err": f_err / f_scale,
          "k1_p_vs_torch_eos": eos, "kernels": res})
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import sph_tpu_torch as sph  # without the package: fail before any output

    if sys.argv[1:2] == ["--decomp-rank"]:      # a rank of phase 33
        return decomp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4])

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
    # and on the cap-8 lattice of the adaptive policy (its occupancy-fit
    # skin at step 0)
    at_cap8, cap8_skins, cap8_grids = {}, {}, {}
    for p in ("dam3d_100k", "splash3d_1m"):
        scene = sph.preset(p)
        cap8_skins[p], cap8_grids[p] = cap8_lattice(
            scene, sph.init(scene, device=dev))
        at_cap8[p] = phase_kernels(p, dev, grid=cap8_grids[p],
                                   lattice="cap 8")
    # this slice: the resident block's passes on the same lattices
    at_pass = {p: phase_slot_pass(p, dev)
               for p in ("dam3d_100k", "splash3d_1m")}
    at_pass8 = {p: phase_slot_pass(p, dev, grid=cap8_grids[p],
                                   lattice="cap 8")
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
    phase_profile_resident("emitters3d@settled", scene_e, settled, 12, dev,
                           packed_rows=True)

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

    # the user's entry point: the cap-8 policy, the grid method, the CLI
    for name in ("dam3d_100k", "splash3d_1m"):
        runs[f"cap8:{name}"] = phase_cap8(name, dev)
    phase_cap8_switch(dev)
    phase_grid("dam2d_10k", 200, dev)
    phase_grid("dam3d_100k", 10, dev)
    phase_cli()

    # this slice: domain decomposition on torch.distributed
    import tempfile

    from sph_tpu_torch import comm

    with tempfile.TemporaryDirectory() as tmp, process_group(
            comm.backend_for(dev), 1, 0, tmp):
        phase_decomp_dp(dev)
        decomp_runs = {p: phase_decomp_slab(p, dev)
                       for p in ("dam3d_100k", "splash3d_1m")}
        # this slice: the slab fast path, its classic form, heal and
        # demotion across slabs
        fast_runs = {p: phase_decomp_fast(p, dev)
                     for p in ("dam3d_100k", "splash3d_1m")}
        classic = phase_decomp_classic(dev)
        heal1 = phase_decomp_heal(dev)
        # this slice: pencils, and the command line's --shards
        pencil_runs = {p: phase_decomp_pencil(p, dev)
                       for p in ("dam3d_100k", "splash3d_1m")}
    at_slab = phase_kernels_slab(dev)
    at_slab_skin = phase_kernels_slab(
        dev, skin=sph.default_skin(sph.preset("dam3d_100k"),
                                   RESIDENT["sort_every"]))
    at_pencil = phase_kernels_pencil(dev)
    # the resident block's passes on rank 1's skinned slab lattice, with
    # its ghosts, ci_offset and faces
    from sph_tpu_torch.decomp import _Slab

    scene_s, s0_s, spec_s, grid_s, geo_s, local_s, ghosts_s, _, lat_s = \
        slab_rank1(dev, sph.default_skin(sph.preset("dam3d_100k"),
                                         RESIDENT["sort_every"]))
    at_pass_slab = phase_slot_pass(
        "dam3d_100k", dev, lattice=lat_s,
        slab=(scene_s, s0_s, grid_s, local_s[:3], ghosts_s, geo_s[1][2],
              _Slab(axis=spec_s.axis, first=False, last=False,
                    lo=float(geo_s[1][0]), hi=float(geo_s[1][1]),
                    ci_off=geo_s[1][2])))
    ranks = phase_decomp_ranks(dev)
    phase_cli_shards()
    # this slice: the command line's frame split, and the bench
    phase_cli_frames()
    # this slice: the whole arc — the settled checkpoints (which the
    # bench's @settled rows read), the soaks, the cap-evidence tools
    phase_settled(dev, smi)
    soaks = {"soak_1m": phase_soak_1m(dev, smi),
             "soak_spatial": phase_soak_spatial(dev, smi),
             **{f"soak_emitters {c}": r for c, r in
                phase_soak_emitters(dev, smi).items()}}
    tools = phase_spill_sweep(dev, smi)
    bench = phase_bench(dev, smi)
    soak_counts = {
        **{k: r["launches"] for k, r in soaks.items()},
        "measure_spill": tools["spill"]["launches"],
        "bench_sweep": tools["sweep_launches"],
        f"bench emitters3d@settled ({bench['settled_layout']})": {
            k: bench["settled_launches"][k] for k in (
                "slot_density", "slot_force", "slot_pre", "slot_post",
                "packed_density", "packed_force")}}

    def soak_of(name):
        return {"soaks": {k: c[name] for k, c in soak_counts.items()},
                "settled_maker": "a subprocess: its launches are not read"}

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
            "at_cap8": {
                p: {"lattice": "cap 8", "skin": cap8_skins[p],
                    "launches": runs[f"cap8:{p}"]["launches"][name],
                    **at_cap8[p][name]}
                for p in ("dam3d_100k", "splash3d_1m")},
            **resident(name),
            "bench": {"/".join(BENCH_FLAGSHIP): bench["launches"][name]},
            "at_cap32": {"preset": "dam3d_100k", "lattice": "cap 32",
                         "launches": tools["sweep_launches"][name],
                         **tools["at_cap32"][name]},
            **soak_of(name),
            "at_slab": {"lattice": "slab-local, rank 1 of 4, dam3d_100k",
                        **at_slab[name]},
            "at_slab_skinned": {
                "lattice": "skinned slab-local (sort_every=4), rank 1 of 4, "
                           "dam3d_100k", **at_slab_skin[name]},
            "at_pencil": {
                "lattice": "pencil-local (pc), rank (1, 1) of 2x2, "
                           "dam3d_100k", **at_pencil[name]},
            "decomposed": {
                **{f"decomp_slab {p}": decomp_runs[p]["launches"][name]
                   for p in ("dam3d_100k", "splash3d_1m")},
                **{f"decomp_fast {p}": fast_runs[p]["launches"][name]
                   for p in ("dam3d_100k", "splash3d_1m")},
                "decomp_classic dam3d_100k": classic["launches"][name],
                "decomp_heal jet": heal1["launches"][name],
                **{f"decomp_ranks rank {r['rank']}": r["launches"][name]
                   for r in ranks["ranks"]},
                **{f"decomp_ranks fast rank {r['rank']}":
                   r["fast"]["launches"][name] for r in ranks["ranks"]},
                **{f"decomp_ranks jet rank {r['rank']}":
                   r["heal"]["launches"][name] for r in ranks["ranks"]},
                **{f"decomp_pencil {p}": pencil_runs[p]["launches"][name]
                   for p in ("dam3d_100k", "splash3d_1m")},
                **{f"decomp_pencil_ranks rank {r['rank']}":
                   r["pencil"]["launches"][name] for r in ranks["ranks"]}},
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
            **soak_of(name),
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
    for name in ("slot_pre", "slot_post"):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": runs["resident:dam3d_100k"]["launches"][name],
            **at_pass["dam3d_100k"][name],
            "at_scale": {"preset": "splash3d_1m", "lattice": "sort_every=4",
                         "launches":
                             runs["resident:splash3d_1m"]["launches"][name],
                         **at_pass["splash3d_1m"][name]},
            "at_cap8": {
                p: {"lattice": "cap 8", "skin": cap8_skins[p],
                    "launches": runs[f"cap8:{p}"]["launches"][name],
                    **at_pass8[p][name]}
                for p in ("dam3d_100k", "splash3d_1m")},
            "at_slab_skinned": {"lattice": lat_s, **at_pass_slab[name]},
            **resident(name),
            "decomposed": {f"decomp_fast {p}": fast_runs[p]["launches"][name]
                           for p in ("dam3d_100k", "splash3d_1m")},
            **soak_of(name),
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
