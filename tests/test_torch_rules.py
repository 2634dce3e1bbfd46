"""Rules of the port: `sph_tpu_torch` imports neither JAX nor `sph_tpu`,
entry points never fall back to the CPU on their own, CPU tensors never
count as kernel launches, non-CPU tensors never take the plain version,
and options outside this slice raise NotImplementedError."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sph_tpu_torch as port
from sph_tpu_torch import _build, platform, slot_kernels
from sph_tpu_torch import pallas_step as tps
from sph_tpu_torch.neighbors import GridSpec

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _scene():
    return port.calibrate(port.Scene(
        lo=(0.0, 0.0), hi=(200.0, 200.0),
        blocks=(port.Block(lo=(20.0, 20.0), hi=(80.0, 100.0)),),
    ))


def test_import_pulls_in_neither_jax_nor_sph_tpu():
    code = (
        "import sys, sph_tpu_torch, sph_tpu_torch.step, "
        "sph_tpu_torch.pallas_step, sph_tpu_torch.slot_kernels, "
        "sph_tpu_torch._build\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'sph_tpu' or m.startswith('sph_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("entry", ["init", "make_step", "make_advance",
                                   "prime", "run"])
def test_entry_points_raise_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = _scene()
    state = port.init(scene, device="cpu")
    calls = {
        "init": lambda: port.init(scene),
        "make_step": lambda: port.make_step(scene, "pallas"),
        "make_advance": lambda: port.make_advance(scene, "pallas"),
        "prime": lambda: port.prime(scene, state, "pallas"),
        "run": lambda: port.run(scene, 2, method="pallas"),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_cpu_run_leaves_launch_counts_at_zero():
    slot_kernels.reset_launches()
    state = port.run(_scene(), 3, method="pallas", device="cpu")
    assert int(state.step) == 3
    assert slot_kernels.LAUNCHES == {"slot_density": 0, "slot_force": 0}


def test_steps_make_no_tensors_from_host_values(monkeypatch):
    """After its first step a step reuses the device constants it made
    then: on the card a tensor made from host values is a blocking copy,
    which would make the host wait on the device every step."""
    scene = _scene()
    scene = scene.replace(params=scene.params.replace(boundary_mode="penalty"))
    step = port.make_step(scene, "pallas", device="cpu")
    state = step(port.init(scene, device="cpu"))
    made = platform.device_const.cache_info().misses

    def refuse(*args, **kw):
        raise AssertionError("a step made a tensor from host values")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    state = step(step(state))
    assert int(state.step) == 3
    assert platform.device_const.cache_info().misses == made


def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch, tmp_path):
    """A tensor off the CPU goes to the kernel or raises: here the build
    fails (no nvcc), and nothing is computed or counted."""
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    slot_kernels.reset_launches()
    m = torch.device("meta")
    feat = torch.empty((3, 8, 384), device=m)
    n_occ = torch.empty((1,), dtype=torch.int32, device=m)
    nbr = torch.empty((3, 3), dtype=torch.int32, device=m)
    gc = torch.empty((3, 1, 3), dtype=torch.int32, device=m)
    p = port.SimParams()
    with pytest.raises(RuntimeError, match="nvcc"):
        slot_kernels.slot_density(feat, n_occ, nbr, gc, 16, p)
    with pytest.raises(RuntimeError, match="nvcc"):
        slot_kernels.slot_force(feat, torch.empty((3, 2, 384), device=m),
                                n_occ, nbr, gc, 16, p)
    assert slot_kernels.LAUNCHES == {"slot_density": 0, "slot_force": 0}


def test_wrappers_reject_malformed_slot_arrays():
    feat = torch.zeros((3, 8, 384))
    n_occ = torch.zeros((1,), dtype=torch.int32)
    nbr = torch.zeros((3, 3), dtype=torch.int32)
    gc = torch.zeros((3, 1, 3), dtype=torch.int32)
    p = port.SimParams()
    with pytest.raises(TypeError):
        slot_kernels.slot_density(feat, n_occ.long(), nbr, gc, 16, p)
    with pytest.raises(ValueError):
        slot_kernels.slot_density(feat[:, :4], n_occ, nbr, gc, 16, p)
    with pytest.raises(ValueError):
        slot_kernels.slot_force(feat, torch.zeros((3, 2, 128)), n_occ, nbr,
                                gc, 16, p)


OUT_OF_SLICE = {
    "sort_every": lambda s: port.run(s, 4, "pallas", sort_every=4, device="cpu"),
    "slot_resident": lambda s: port.run(s, 4, "pallas", slot_resident=True,
                                        device="cpu"),
    "adaptive_cap": lambda s: port.run(s, 4, "pallas", adaptive_cap=True,
                                       device="cpu"),
    "shards": lambda s: port.run(s, 4, "pallas", shards=2, device="cpu"),
    "packed_rows": lambda s: port.run(s, 4, "pallas", packed_rows=True,
                                      device="cpu"),
    "row_pair": lambda s: port.make_step(s, "pallas", row_pair=True,
                                         device="cpu"),
    "xsub": lambda s: port.make_advance(s, "pallas", xsub=2, device="cpu"),
    "xsub_grid": lambda s: tps.slot_grid(GridSpec.for_scene(s, xsub=2)),
    "bf16": lambda s: port.make_step(
        s.replace(params=s.params.replace(precision="bf16")), "pallas",
        device="cpu"),
    "grid": lambda s: port.make_step(s, "grid", device="cpu"),
}


@pytest.mark.parametrize("option", sorted(OUT_OF_SLICE))
def test_out_of_slice_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        OUT_OF_SLICE[option](_scene())


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        port.make_step(_scene(), "magic", device="cpu")
