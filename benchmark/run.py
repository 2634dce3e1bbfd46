"""Run one benchmark cell once and print its result as the last line of
standard output.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (`sph_tpu_torch/`).
Needs as many CUDA cards as the cell asks for: without them it exits 2 and
prints no result.  With `--trace 0` the result holds the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics.  The numbers compared to
decide `correct` end standard error, each beside its limit, and end the
result line under `checks`.
"""

from __future__ import annotations

import time

T_PROC0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark.spec import ROOT  # noqa: E402

# kernel and build caches at fixed paths inside the checkout, so that only
# a checkout's first run builds
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_ext",
          "CUDA_CACHE_PATH": "cuda"}
# one host thread for the CPU-side work of the program and the harness: the
# run is paced by one Python thread, which idle-spinning pool threads on a
# shared host would slow
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
           "OPENBLAS_NUM_THREADS": "1"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    os.environ.update(THREADS)

    import torch

    torch.set_num_threads(1)

    from benchmark import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed % 2**63, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_PROC0)
    if result is None:
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
