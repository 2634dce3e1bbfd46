"""Point-splat renderer and frame output (port of `sph_tpu/render.py`).

The frame is rasterized on the state's device: each particle's splat is
scatter-added into an [H, W] buffer, and only the finished image crosses
to the host.  Headless output: a dependency-free PNG writer (stdlib zlib),
a tiny colormap, and the native encoder (`io_native`) where it loads.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from sph_tpu_torch import io_native
from sph_tpu_torch.params import Scene
from sph_tpu_torch.platform import device_const
from sph_tpu_torch.state import State


def render_splat(
    state: State,
    scene: Scene,
    width: int = 400,
    height: int = 300,
    mode: str = "density",
    axes: tuple[int, int] = (0, 1),
    radius: int = 1,
) -> torch.Tensor:
    """Rasterize particles into an [H, W] float32 field on the state's
    device.

    mode: "density" (splat count), "rho" (mean density), "speed" (mean |v|),
    "depth" (3D only: depth-shaded splat — near particles brighter).
    axes: which position components map to (x, y) of the image (3D scenes
    render an orthographic projection along the remaining axis).
    radius: splat radius in pixels; each particle covers a (2r+1)² stencil
    with a cosine-bell falloff (radius=0: one pixel).  The scatter adds in
    an order of its own, so a pixel matches the reference's to rounding.
    """
    ax, ay = axes
    dev = state.x.device
    lo = device_const(tuple(scene.lo), torch.float32, dev)
    hi = device_const(tuple(scene.hi), torch.float32, dev)
    act = state.active
    u = (state.x[:, ax] - lo[ax]) / (hi[ax] - lo[ax]) * (width - 1)
    v = (state.x[:, ay] - lo[ay]) / (hi[ay] - lo[ay]) * (height - 1)
    px = torch.round(u).to(torch.int64)
    # image row 0 = top; simulation y up
    py = height - 1 - torch.round(v).to(torch.int64)
    # out-of-frame or inactive → far index, every tap of it dropped
    ok = act & (px >= -radius) & (px < width + radius)
    ok = ok & (py >= -radius) & (py < height + radius)
    px = torch.where(ok, px, -(1 << 20))
    spare = height * width     # one element past the image takes the drops

    def stencil_add(val):
        img = torch.zeros(spare + 1, dtype=torch.float32, device=dev)
        r2max = (radius + 0.5) ** 2
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                wgt = max(0.0, 1.0 - (dx * dx + dy * dy) / r2max)
                if wgt <= 0.0:
                    continue
                iy, ix = py + dy, px + dx
                oob = (iy < 0) | (iy >= height) | (ix < 0) | (ix >= width)
                img.index_add_(0, torch.where(oob, spare, iy * width + ix),
                               val * float(np.float32(wgt)))
        return img[:spare].reshape(height, width)

    w = ok.to(torch.float32)
    if mode == "density":
        return stencil_add(w)
    if mode == "rho":
        return stencil_add(w * state.rho) / torch.clamp(stencil_add(w),
                                                        min=1e-6)
    if mode == "speed":
        speed = torch.sqrt(torch.sum(state.v * state.v, dim=-1))
        return stencil_add(w * speed) / torch.clamp(stencil_add(w), min=1e-6)
    if mode == "depth":
        # particles near the viewer (large coordinate along the projection
        # axis) splat brighter: an orthographic depth cue
        if state.dim < 3:
            raise ValueError("render mode 'depth' needs a 3D scene")
        az = ({0, 1, 2} - {ax, ay}).pop()
        dnorm = (state.x[:, az] - lo[az]) / (hi[az] - lo[az])
        shade = torch.clamp(0.15 + 0.85 * dnorm, 0.0, 1.0) ** 2
        return stencil_add(w * shade)
    raise ValueError(f"unknown render mode {mode!r}")


def colorize(
    field: np.ndarray, gamma: float = 0.5, top: float | None = None
) -> np.ndarray:
    """[H, W] scalar → [H, W, 3] uint8, dark-blue→cyan→white water map.

    `top` fixes the normalization scale; None autoscales to this frame's
    99th percentile (recordings pass a sequence-wide `top`, so brightness
    does not flicker from frame to frame)."""
    f = np.asarray(field, np.float32)
    if top is None:
        top = np.percentile(f[f > 0], 99.0) if np.any(f > 0) else 1.0
    t = np.clip(f / max(top, 1e-9), 0.0, 1.0) ** gamma
    r = np.clip(t * 2.0 - 1.0, 0.0, 1.0)
    g = np.clip(t * 1.6 - 0.2, 0.0, 1.0)
    b = np.clip(0.2 + t * 0.8, 0.0, 1.0) * (t > 0) + 0.07 * (t == 0)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal RGB8 PNG writer (stdlib only)."""
    h, w, _ = rgb.shape
    raw = b"".join(
        b"\x00" + rgb[i].astype(np.uint8).tobytes() for i in range(h)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as fh:
        fh.write(png)


def save_frame(
    state: State, scene: Scene, path: str, width=400, height=300,
    mode="density", radius=1, top=None,
) -> None:
    field = render_splat(state, scene, width, height, mode,
                         radius=radius).cpu().numpy()
    rgb = colorize(field, top=top)
    if not io_native.write_png(path, rgb):   # native encoder, if it loads
        write_png(path, rgb)                 # pure-Python fallback


def sequence_scale(fields: list[np.ndarray]) -> float:
    """One normalization scale for a whole recording (99th percentile of
    positive pixels across ALL frames) — per-frame autoscale flickers."""
    pos = [f[f > 0] for f in (np.asarray(f, np.float32) for f in fields)]
    pos = [p for p in pos if p.size]
    if not pos:
        return 1.0
    return float(np.percentile(np.concatenate(pos), 99.0))


def save_apng(path: str, fields: list[np.ndarray], fps: float = 20.0) -> None:
    """Encode a field sequence to an animated PNG (native encoder; without
    it, per-frame PNGs next to `path`).  All frames share one
    normalization scale."""
    top = sequence_scale(fields)
    frames = np.stack([colorize(f, top=top) for f in fields])
    if not io_native.write_apng(path, frames, fps=fps):
        base, _ = path.rsplit(".", 1)
        for i, frame in enumerate(frames):
            write_png(f"{base}_{i:05d}.png", frame)
