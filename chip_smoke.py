#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`sph_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

  1. card     nvidia-smi name and power limit, torch and CUDA versions
  2. build    nvcc build of the slot kernels from csrc/, with the
              -Xptxas -v register/spill lines
  3. kernels  at dam3d_100k and splash3d_1m (the slot arrays of step 0):
              K1 and K2 against their plain PyTorch versions on the same
              inputs (rho rtol 1e-5 atol 1e-6 per particle; f max-relative
              3e-5 — the reference suite's own tolerances between its paths,
              summation order differs), CUDA-event times, and the bound
  4. path     run(preset("dam3d_100k"), 200, method="pallas") on the card:
              finite state, no cap overflow, mean rho/rho0 of the fluid in
              [0.90, 1.10], max|v| < 500, and each kernel launched exactly
              201 times (200 steps + prime); ms/step and peak memory
  5. path     the same at splash3d_1m for 20 steps
  6. determinism  two 20-step dam3d_100k runs give bitwise-equal x
  7. no_sync  two dam3d_100k steps under torch's sync debug mode "error":
              a step never waits on the host
  8. profile  torch.profiler over steps at both sizes: device time per
              step by kernel, and the device's busy share of the wall time
  then the {"kernels": [...]} summary, the nvidia-smi line, and last
  {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero without the last
line.  It imports neither JAX nor `sph_tpu`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 FLOP/s
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# fp32 operations per candidate pair, counted from the kernel source (3D):
# K1: 3 sub, 3 mul + 2 add for r², h²−r², max, q³ (2 mul), accumulate;
# K2: r² (8), max + sqrt + divide, r²·inv_r, h−, max, c_s·t·t·inv_r (3),
#     max + divide for 1/ρ_j, p_i+p_j, coef_p (3), coef_v (3), and per
#     component sub, 2 mul, 2 add (15)
OPS_PER_PAIR = {"slot_density": 13, "slot_force": 41}
REPLACES = {
    "slot_density": "sph_tpu/pallas_step.py:750 (_density_kernel)",
    "slot_force": "sph_tpu/pallas_step.py:837 (_force_kernel)",
}
SOURCE = "sph_tpu_torch/csrc/slot_kernels.cu"
RHO_RTOL, RHO_ATOL, F_REL = 1e-5, 1e-6, 3e-5
N_TIMED = 20


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


def phase_build():
    from sph_tpu_torch import _build

    built = _build.build("slot_kernels", force=True)
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "library": built.path.name,
          "seconds": built.seconds, "ptxas": ptxas})


def slot_inputs(scene, dev):
    from sph_tpu_torch import init, neighbors, pallas_step as ps

    state = init(scene, device=dev)
    grid = neighbors.GridSpec.for_scene(scene)
    sg = ps.slot_grid(grid)
    addr = ps.build_addr(state.x, state.active, grid, sg)
    feat = ps.scatter_slots(addr, ps._pack_rows6(state.x, state.v), sg)
    return sg, addr, feat


def real_pairs(feat, addr, sg) -> int:
    """Candidate pairs of real particles the kernels must evaluate on these
    inputs: each live i-slot against the real j-slots of its window."""
    from sph_tpu_torch import slot_kernels as sk

    total = 0
    for _, _, nr, j in sk._chunks(feat, addr.n_occ, addr.nbr_pos,
                                  addr.gcounts, sg.cap):
        total += int(torch.sum(sk._take(feat, nr, j, 0) < 1e17))
    return total


def bound(name: str, feat, addr, sg, dim: int, pairs: int):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the fp32 rate, from this run's inputs.  Only the
    occupied rows 1..n_occ are read and written: the gathers read no other
    row, so the zeros the kernels write past n_occ are not counted."""
    n_occ = int(addr.n_occ[0])
    lanes = feat.shape[2]
    if name == "slot_density":   # read x, write rho and p
        moved = n_occ * lanes * (dim + 2) * 4
    else:                        # read x, v, rho and p, write f
        moved = n_occ * lanes * (2 * dim + 2 + dim) * 4
    t_bytes = moved / PEAK_BYTES_S * 1e3
    t_ops = pairs * OPS_PER_PAIR[name] / PEAK_F32_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(preset_name: str, dev):
    """K1 and K2 against their plain versions on the step-0 slot arrays."""
    from sph_tpu_torch import pallas_step as ps, preset, slot_kernels as sk

    scene = preset(preset_name)
    params = scene.params
    sg, addr, feat = slot_inputs(scene, dev)
    args = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params)

    rp_k = sk.slot_density(feat, *args)
    rp_p = sk.density_plain(feat, *args)
    torch.cuda.synchronize()
    rho_k, ok = ps._gather_rho(rp_k, addr, sg, params)
    rho_p, _ = ps._gather_rho(rp_p, addr, sg, params)
    check(bool(torch.allclose(rho_k, rho_p, rtol=RHO_RTOL, atol=RHO_ATOL)),
          f"K1 vs plain at {preset_name}")
    f_k = sk.slot_force(feat, rp_k, *args)
    f_p = sk.force_plain(feat, rp_k, *args)
    torch.cuda.synchronize()
    d = params.dim
    fk = ps._gather_f(f_k, addr, sg, d, ok)
    fp = ps._gather_f(f_p, addr, sg, d, ok)
    f_err = float(torch.max(torch.abs(fk - fp)))
    f_scale = float(torch.max(torch.abs(fp)))
    check(f_err / f_scale < F_REL, f"K2 vs plain at {preset_name}")
    check(bool(torch.isfinite(rho_k).all() and torch.isfinite(fk).all()),
          f"finite kernel outputs at {preset_name}")

    pairs = real_pairs(feat, addr, sg)
    res = {}
    for name, kern, plain, err in (
        ("slot_density", lambda: sk.slot_density(feat, *args),
         lambda: sk.density_plain(feat, *args),
         float(torch.max(torch.abs(rho_k - rho_p)))),
        ("slot_force", lambda: sk.slot_force(feat, rp_k, *args),
         lambda: sk.force_plain(feat, rp_k, *args), f_err),
    ):
        b_ms, b_by = bound(name, feat, addr, sg, d, pairs)
        res[name] = {
            "max_abs_err": err, "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    emit({"phase": "kernels", "preset": preset_name,
          "c_rows": sg.c_rows, "lanes": sg.lanes, "n_groups": sg.n_groups,
          "n_occ": int(addr.n_occ[0]), "particles": int(ok.sum()),
          "candidate_pairs": pairs, "f_max_rel_err": f_err / f_scale,
          "kernels": res})
    return res


def phase_path(preset_name: str, n_steps: int, dev):
    """The port's main path through `run`, with its health checks."""
    from sph_tpu_torch import init, neighbors, pallas_step as ps, preset, run
    from sph_tpu_torch import slot_kernels as sk

    scene = preset(preset_name)
    grid = neighbors.GridSpec.for_scene(scene)
    sg = ps.slot_grid(grid)
    seen = {"overflow": 0, "n_occ": 0}

    def audit(st):  # build-time cap overflow of the state a dispatch ends on
        addr = ps.build_addr(st.x, st.active, grid, sg)
        seen["overflow"] = max(seen["overflow"], int(addr.overflow))
        seen["n_occ"] = int(addr.n_occ[0])

    state = init(scene, device=dev)
    audit(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.reset_launches()
    t0 = time.perf_counter()
    state = run(scene, n_steps, method="pallas", steps_per_dispatch=n_steps,
                state=state, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    audit(state)

    act = state.active
    fluid = act & (state.kind == 0)
    finite = all(bool(torch.isfinite(getattr(state, f)).all())
                 for f in ("x", "v", "acc", "rho", "p"))
    rho_ratio = float(state.rho[fluid].mean()) / scene.params.rest_density
    vmax = float(torch.linalg.vector_norm(state.v[act], dim=1).max())
    out = {"phase": "path", "preset": preset_name, "steps": n_steps,
           "particles": int(act.sum()), "ms_per_step": wall / n_steps * 1e3,
           "ms_per_step_note": "host clock over run(), prime included",
           "peak_bytes": peak, "launches": launches,
           "overflow": seen["overflow"], "n_occ": seen["n_occ"],
           "rho_mean_over_rest": rho_ratio, "max_speed": vmax}
    emit(out)
    check(finite, f"finite state at {preset_name}")
    check(seen["overflow"] == 0, f"no cap overflow at {preset_name}")
    check(0.90 <= rho_ratio <= 1.10, f"mean rho/rho0 at {preset_name}")
    check(vmax < 500.0, f"max|v| < 500 at {preset_name}")
    for name in launches:
        check(launches[name] == n_steps + 1,
              f"{name} launched {launches[name]} times, want {n_steps + 1}")
    return out


def phase_determinism(dev):
    from sph_tpu_torch import init, preset, run

    scene = preset("dam3d_100k")
    s0 = init(scene, device=dev)
    a = run(scene, 20, method="pallas", state=s0, device=dev)
    b = run(scene, 20, method="pallas", state=s0, device=dev)
    same = bool(torch.equal(a.x, b.x))
    emit({"phase": "determinism", "preset": "dam3d_100k", "steps": 20,
          "bitwise_equal_x": same})
    check(same, "two runs from one init give bitwise-equal x")


def phase_no_sync(dev):
    """Steps enqueue their work without waiting on the host: two steps run
    under torch's sync debug mode "error", which raises at any call that
    synchronizes the host with the card (a blocking copy, .item(),
    nonzero).  One step before it makes the cached device constants."""
    from sph_tpu_torch import init, make_advance, preset, prime

    scene = preset("dam3d_100k")
    advance = make_advance(scene, "pallas", steps_per_dispatch=2, device=dev)
    state = prime(scene, init(scene, device=dev), "pallas", device=dev)
    state = advance(state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = advance(state)
        try:  # the mode must catch the kind of copy the steps no longer make
            torch.tensor((1.0,), device=dev)
            caught = False
        except RuntimeError:
            caught = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(caught, "sync debug mode catches a blocking host-to-device copy")
    check(bool(torch.isfinite(state.x).all()), "finite state after no-sync steps")
    emit({"phase": "no_sync", "preset": "dam3d_100k", "steps": 2,
          "sync_debug_mode": "error", "host_syncs": 0})


def phase_profile(preset_name: str, n_steps: int, dev):
    """Where a step's device time goes (informational: no check)."""
    from torch.profiler import ProfilerActivity, profile

    from sph_tpu_torch import init, make_step, preset, run

    scene = preset(preset_name)
    state = run(scene, 2, method="pallas", state=init(scene, device=dev),
                device=dev)
    step = make_step(scene, "pallas", device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []  # device-side events only (kernels, memcpy, memset)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.device_time_total / 1e3 / n_steps,
                         e.count / n_steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    emit({"phase": "profile", "preset": preset_name, "steps": n_steps,
          "wall_ms_per_step_profiled": wall / n_steps * 1e3,
          "device_ms_per_step": busy,
          "device_busy_share": busy / (wall / n_steps * 1e3),
          "device_ops_per_step": sum(r[1] for r in rows),
          "top": [{"ms_per_step": ms, "per_step": c, "name": k[:90]}
                  for ms, c, k in rows[:12]]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import sph_tpu_torch  # noqa: F401  (without the package: fail before any output)

    dev = torch.device("cuda")
    smi = smi_line()
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})
    phase_build()
    at = {p: phase_kernels(p, dev) for p in ("dam3d_100k", "splash3d_1m")}
    main_run = phase_path("dam3d_100k", 200, dev)
    big_run = phase_path("splash3d_1m", 20, dev)
    phase_determinism(dev)
    phase_no_sync(dev)
    phase_profile("dam3d_100k", 10, dev)
    phase_profile("splash3d_1m", 5, dev)

    kernels = []
    for name in ("slot_density", "slot_force"):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": main_run["launches"][name],
            **at["dam3d_100k"][name], "library_ms": None,
            "at_scale": {"preset": "splash3d_1m",
                         "launches": big_run["launches"][name],
                         **at["splash3d_1m"][name]},
        })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
