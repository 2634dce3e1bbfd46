"""The harness, the reference and a pass of the program load no module of
JAX or of the JAX package, and open nothing under `bench/`."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from benchmark import spec

PROBE = r"""
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str) else None)
import torch
import benchmark.run, benchmark.harness, benchmark.check, benchmark.trace
import benchmark.readings
import benchmark.reference.sph, benchmark.reference.seed_state
from benchmark import harness, spec
from benchmark.tests.small import small_cell
for m in spec.load_benchmark()["per_layer"]:
    spec.reader(m["name"])
prog = harness.Program(small_cell(steps=8, spf=8), 7, torch.device("cpu"))
prog.run_pass()
print(json.dumps({"modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": opened}))
"""


def test_no_jax_and_no_bench_folder():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(spec.ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert not {"jax", "jaxlib", "flax", "sph_tpu"} & set(got["modules"])
    assert "sph_tpu_torch" in got["modules"]
    bench = str(spec.ROOT / "bench")
    assert not [p for p in got["opened"]
                if p == bench or p.startswith(bench + "/")
                or p.startswith("bench/")]
