"""The port's renderer and frame output (`sph_tpu_torch.render`,
`sph_tpu_torch.io_native`) against the reference's on the same states and
pixels.

`render_splat` scatter-adds in an order of its own, so its fields agree
within 1e-5 of their largest pixel (exactly where every pixel is a count:
the density mode at radius 0); `colorize`, `sequence_scale` and the
pure-Python `write_png` are the reference's bytes; PNG and APNG files
written through the port's native loader are byte-equal to those written
through the reference's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import small_scene
from sph_tpu import io_native as ref_io
from sph_tpu import render as ref_render
from sph_tpu_torch import io_native, render
from test_torch_resident import _pair

torch.set_num_threads(1)


def _rgb(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("dim,mode,radius", [
    (2, "density", 0), (2, "density", 1), (2, "rho", 1), (2, "speed", 2),
    (3, "density", 1), (3, "depth", 1),
])
def test_render_splat_matches_reference(dim, mode, radius):
    rs, rst, scene, ost = _pair(small_scene(dim=dim, seed=80))
    v = np.random.default_rng(81).uniform(-20, 20, ost.v.shape)
    ost = ost.replace(v=torch.from_numpy(v.astype(np.float32)))
    rst = dataclasses.replace(rst, v=jnp.asarray(ost.v.numpy()))
    ours = render.render_splat(ost, scene, 160, 120, mode, radius=radius)
    ref = np.asarray(ref_render.render_splat(rst, rs, 160, 120, mode,
                                             radius=radius))
    assert ours.shape == (120, 160) and ours.dtype == torch.float32
    if (mode, radius) == ("density", 0):
        assert np.array_equal(ours.numpy(), ref)
        assert ours.sum() == int(ost.n_active())
    else:
        assert np.allclose(ours.numpy(), ref, rtol=1e-5,
                           atol=1e-5 * np.abs(ref).max())


def test_render_drops_out_of_frame_and_rejects_2d_depth():
    rs, rst, scene, ost = _pair(small_scene(dim=2, seed=82))
    away = scene.replace(lo=(-500.0, -500.0), hi=(-100.0, -100.0))
    assert render.render_splat(ost, away, 64, 64, radius=1).sum() == 0
    with pytest.raises(ValueError, match="3D scene"):
        render.render_splat(ost, scene, 64, 64, "depth")


@pytest.mark.parametrize("top", [None, 3.0])
def test_colorize_and_sequence_scale_equal_reference(top):
    fields = [np.random.default_rng(s).gamma(0.5, 2.0, (30, 40))
              .astype(np.float32) * (np.arange(40) % 3 > 0) for s in (1, 2)]
    assert render.sequence_scale(fields) == ref_render.sequence_scale(fields)
    assert render.sequence_scale([np.zeros((2, 2))]) == 1.0
    for f in fields:
        assert np.array_equal(render.colorize(f, top=top),
                              ref_render.colorize(f, top=top))


def test_pure_python_png_bytes_equal_reference(tmp_path):
    rgb = _rgb(70, (48, 64, 3))
    render.write_png(str(tmp_path / "a.png"), rgb)
    ref_render.write_png(str(tmp_path / "b.png"), rgb)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


def _need_native():
    if not (io_native.available() and ref_io.available()):
        pytest.skip("no g++/zlib to build native/sphio.cpp")


def test_native_png_and_apng_bytes_equal_reference(tmp_path):
    _need_native()
    rgb = _rgb(71, (48, 64, 3))
    assert io_native.write_png(str(tmp_path / "a.png"), rgb)
    assert ref_io.write_png(str(tmp_path / "b.png"), rgb)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    frames = _rgb(72, (5, 32, 40, 3))
    assert io_native.write_apng(str(tmp_path / "a.apng"), frames, fps=10)
    assert ref_io.write_apng(str(tmp_path / "b.apng"), frames, fps=10)
    data = (tmp_path / "a.apng").read_bytes()
    assert data == (tmp_path / "b.apng").read_bytes()
    assert b"acTL" in data and b"fdAT" in data
    with pytest.raises(ValueError):
        io_native.write_png(str(tmp_path / "c.png"), rgb[..., :2])


def test_save_frame_and_apng_bytes_equal_reference(tmp_path):
    """Frames through the native encoder: radius 0 density fields are
    exact counts, so the files are the reference's bytes."""
    _need_native()
    rs, rst, scene, ost = _pair(small_scene(dim=2, seed=83))
    render.save_frame(ost, scene, str(tmp_path / "a.png"), 120, 90, radius=0)
    ref_render.save_frame(rst, rs, str(tmp_path / "b.png"), 120, 90,
                          radius=0)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    fields = [render.render_splat(ost, scene, 60, 40, radius=0).numpy(),
              np.asarray(ref_render.render_splat(rst, rs, 60, 40, radius=0))]
    render.save_apng(str(tmp_path / "a.apng"), fields, fps=10)
    ref_render.save_apng(str(tmp_path / "b.apng"), fields, fps=10)
    assert (tmp_path / "a.apng").read_bytes() == (tmp_path / "b.apng").read_bytes()


def test_apng_falls_back_to_frame_pngs(tmp_path, monkeypatch):
    monkeypatch.setattr(io_native, "_load", lambda: None)
    monkeypatch.setattr(ref_io, "_load", lambda: None)
    fields = [np.full((8, 10), float(k), np.float32) for k in range(3)]
    render.save_apng(str(tmp_path / "a.apng"), fields)
    ref_render.save_apng(str(tmp_path / "b.apng"), fields)
    assert not (tmp_path / "a.apng").exists()
    for k in range(3):
        assert ((tmp_path / f"a_{k:05d}.png").read_bytes()
                == (tmp_path / f"b_{k:05d}.png").read_bytes())
