"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` into a shared library with a plain C
interface and loaded with `ctypes`; no PyTorch headers are involved, so a
build takes seconds.  Libraries go to `sph_tpu_torch/_build/` (listed in
`.gitignore`), named by a hash of the source and the flags, and are built
at first use.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# argtypes per exported function of each library
_SLOT_DENSITY = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                 _I, _F, _F, _F, _F, _F, _F, _I, _P)
_SLOT_FORCE = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F,
               _F, _F, _F, _F, _F, _I, _P)
_PACKED_DENSITY = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _I,
                   _F, _F, _F, _F, _I, _P)
_PACKED_FORCE = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F,
                 _F, _I, _P)
SIGNATURES = {
    "slot_kernels": {
        "slot_density": _SLOT_DENSITY,
        "slot_force": _SLOT_FORCE,
        "slot_density_simple": _SLOT_DENSITY,
        "slot_force_simple": _SLOT_FORCE,
        "slot_stage_bytes": (_I, _I, _I),
    },
    "packed_kernels": {
        "packed_density": _PACKED_DENSITY,
        "packed_force": _PACKED_FORCE,
        "packed_density_simple": _PACKED_DENSITY,
        "packed_force_simple": _PACKED_FORCE,
        # the launch choices (warps, tile, prefetch, band) before device
        "packed_density_variant": (*_PACKED_DENSITY[:-2], _I, _I, _I, _I,
                                   _I, _P),
        "packed_force_variant": (*_PACKED_FORCE[:-2], _I, _I, _I, _I, _I,
                                 _P),
        "packed_defaults": (_P,),
    },
    "stage_kernels": {
        "stage_transpose": (_P, _P, _I, _I, _I, _P),
    },
    "probe_kernels": {
        "probe_f32": (_P, _P, _P, _I, _I, _P),
        "probe_bf16": (_P, _P, _P, _I, _I, _P),
    },
}


@dataclass
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float      # nvcc wall time; 0.0 when an existing build was loaded
    log: str            # nvcc's output (the -Xptxas -v register/spill lines)


_LOADED: dict[str, Built] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("sph_tpu_torch: nvcc not found (PATH, CUDA_HOME)")
    return path


def build(name: str, force: bool = False, defines: tuple = ()) -> Built:
    """Compile `csrc/<name>.cu` (unless a build of the same source, flags
    and preprocessor `defines` exists and `force` is False) and load it.
    `library(name)` is the build without defines."""
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if force or not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags, "-o", str(tmp), str(src)]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"sph_tpu_torch: nvcc failed ({res.returncode}) for {src.name}:\n{log}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    built = Built(lib=lib, path=out, seconds=seconds, log=log)
    if not defines:
        _LOADED[name] = built
    return built


def build_all(force: bool = False) -> dict[str, Built]:
    """Build every library at once, one nvcc process per source."""
    names = sorted(SIGNATURES)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(lambda n: build(n, force), names)))


def library(name: str) -> ctypes.CDLL:
    """The loaded library, built at first use."""
    if name not in _LOADED:
        build(name)
    return _LOADED[name].lib
