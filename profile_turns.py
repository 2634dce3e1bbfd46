#!/usr/bin/env python3
"""Profiles of the port's resident paths and a few bench rows, for one
checkout of the package, so that two versions can be measured in turns on
one CUDA card in one session (parent, change, change, parent: one process
each).

    python3 profile_turns.py [ROOT]

ROOT (default: this checkout) is the directory that holds the
`sph_tpu_torch` package to measure, e.g. a `git archive` of the parent
unpacked into a gitignored directory.  The phases are `chip_smoke.py`'s
own, each printed as one JSON line:

  profiles   the package measured and the nvidia-smi line
  profile    one 12-step dispatch under torch.profiler of resident4auto at
             dam3d_100k and splash3d_1m on cap 16 and the cap-8 policy,
             pinned packed rows at emitters3d@settled, and the one-rank
             slab fast path (NCCL) at both presets: device ms, operations
             a step and busy share (and the resident dispatches' blocks by
             first slot_pre, where the package counts them)
  bench_row  PROFILE_ROWS through `bench_step.bench_one` (100 steps)
"""

from __future__ import annotations

import contextlib
import io
import sys
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs

# the bench rows timed (bench_step.CONFIGS' tags)
PROFILE_ROWS = (("dam3d_100k", "pallas"), ("dam3d_100k", "resident4auto"),
                ("dam3d_100k", "auto8"),
                ("dam3d_100k", "spatial-resident4auto"),
                ("splash3d_1m", "pallas"), ("splash3d_1m", "resident4auto"),
                ("splash3d_1m", "auto8"),
                ("splash3d_1m", "spatial-resident4auto"))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_turns: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        sys.path.insert(0, str(Path(sys.argv[1]).resolve()))
    import sph_tpu_torch as sph
    from sph_tpu_torch import bench_step, comm, decomp

    dev = torch.device("cuda")
    cs.emit({"phase": "profiles", "package": str(Path(sph.__file__).parent),
             "nvidia_smi": cs.smi_line()})
    for name in ("dam3d_100k", "splash3d_1m"):
        scene = sph.preset(name)
        for policy in ({}, {"adaptive_cap": True}):
            cs.phase_profile_resident(name, scene,
                                      sph.init(scene, device=dev), 12, dev,
                                      **policy)
    settled, scene_e = sph.load_checkpoint(str(cs.SETTLED), device=dev)
    cs.phase_profile_resident("emitters3d@settled", scene_e, settled, 12,
                              dev, packed_rows=True)
    with tempfile.TemporaryDirectory() as tmp, cs.process_group(
            comm.backend_for(dev), 1, 0, tmp):
        for name in ("dam3d_100k", "splash3d_1m"):
            scene = sph.preset(name)
            s0 = sph.prime(scene, sph.init(scene, device=dev), "pallas",
                           device=dev)
            spec = decomp.SpatialSpec.for_state(
                scene, s0, 1, skin=sph.default_skin(scene, 4))
            loc = decomp.spatial_shard_state(s0, scene, spec, dev)
            fast = decomp.make_audited_spatial_advance(scene, spec, "pallas",
                                                       12, **cs.RESIDENT)
            with contextlib.redirect_stderr(io.StringIO()):
                cs.emit({"phase": "profile", "preset": name,
                         "run": dict(cs.RESIDENT, shards=1), "steps": 12,
                         **cs.profiled(lambda: fast(loc), 12)})
    for name, method in PROFILE_ROWS:
        with contextlib.redirect_stderr(io.StringIO()):
            ps, per_step, n = bench_step.bench_one(name, method, 100,
                                                   device=dev)
        cs.emit({"phase": "bench_row", "row": f"{name}/{method}", "n": n,
                 "ms_per_step": per_step * 1e3, "psteps_per_s": ps})
    return 0


if __name__ == "__main__":
    sys.exit(main())
