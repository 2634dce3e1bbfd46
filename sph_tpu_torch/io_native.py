"""ctypes binding to the native frame encoder `native/sphio.cpp` (port of
`sph_tpu/io_native.py`, with the same functions and signatures).

The library is built at first use with the flags of `native/Makefile`
(g++ and zlib) into `sph_tpu_torch/_build/`, named by a hash of the source
and the flags; nothing is written into `native/`.  Where the toolchain or
the library is unavailable, `write_png` / `write_apng` return False and the
caller uses the pure-Python encoder in `render.py`: this is host file
output, never a path of the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from sph_tpu_torch._build import BUILD_DIR

SOURCE = BUILD_DIR.parent.parent / "native" / "sphio.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-Wall", "-std=c++17", "-shared")
_lib = None
_tried = False


def _compile():
    """Path of the built library, building it if needed; None on failure."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not SOURCE.exists():
        return None
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"libsphio-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lz"],
            capture_output=True, timeout=120,
        )
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _compile()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    u8p, i = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int
    lib.sphio_write_png.argtypes = [ctypes.c_char_p, u8p, i, i, i]
    lib.sphio_write_png.restype = ctypes.c_int
    lib.sphio_write_apng.argtypes = [ctypes.c_char_p, u8p, i, i, i, i, i, i]
    lib.sphio_write_apng.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_u8_ptr(arr: np.ndarray):
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def write_png(path: str, rgb: np.ndarray, level: int = 6) -> bool:
    """Native PNG write of [H, W, 3] uint8; False if the native path is
    unavailable."""
    lib = _load()
    if lib is None:
        return False
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes [H, W, 3] pixels, got {rgb.shape}")
    a, ptr = _as_u8_ptr(rgb)
    rc = lib.sphio_write_png(path.encode(), ptr, w, h, level)
    if rc != 0:
        raise IOError(f"sphio_write_png failed with code {rc}")
    return True


def write_apng(path: str, frames: np.ndarray, fps: float = 20.0,
               level: int = 6) -> bool:
    """Native animated-PNG write of [N, H, W, 3] uint8 frames; False if the
    native path is unavailable."""
    lib = _load()
    if lib is None:
        return False
    n, h, w, c = frames.shape
    if c != 3:
        raise ValueError(
            f"write_apng takes [N, H, W, 3] frames, got {frames.shape}")
    a, ptr = _as_u8_ptr(frames)
    delay_den = 1000
    delay_num = max(1, int(round(delay_den / fps)))
    rc = lib.sphio_write_apng(
        path.encode(), ptr, n, w, h, delay_num, delay_den, level
    )
    if rc != 0:
        raise IOError(f"sphio_write_apng failed with code {rc}")
    return True
