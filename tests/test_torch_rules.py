"""Rules of the port: `sph_tpu_torch` imports neither JAX nor `sph_tpu`,
entry points (the CLI's too) never fall back to the CPU on their own, CPU
tensors never count as kernel launches (K1-K5, P1), non-CPU tensors never
take the plain version, options the port does not have yet raise
NotImplementedError naming their ROADMAP.md item, and the options it has
run."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sph_tpu_torch as port
from sph_tpu_torch import _build, packed_kernels, platform, slot_kernels
from sph_tpu_torch import stage_kernels
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
        "sph_tpu_torch.packed_kernels, sph_tpu_torch.stage_kernels, "
        "sph_tpu_torch.diagnostics, sph_tpu_torch._build, "
        "sph_tpu_torch.probe_vpu_bf16, sph_tpu_torch.cli, "
        "sph_tpu_torch.render, sph_tpu_torch.io_native, "
        "sph_tpu_torch.neighbors, sph_tpu_torch.comm, "
        "sph_tpu_torch.decomp, sph_tpu_torch.make_settled_state, "
        "sph_tpu_torch.soak_1m, sph_tpu_torch.soak_emitters, "
        "sph_tpu_torch.soak_spatial, sph_tpu_torch.measure_spill, "
        "sph_tpu_torch.bench_sweep\n"
        "import pkgutil\n"
        "for m in pkgutil.iter_modules(sph_tpu_torch.__path__):\n"
        "    __import__('sph_tpu_torch.' + m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib')) or m == 'sph_tpu' or m.startswith('sph_tpu.'))\n"
        "bad += sorted(m for m in sys.modules if m == 'bench' "
        "or m.startswith('bench.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _cli_without_a_card():
    """The CLI exits 1 with resolve_device's one line; the test raises
    that line as `run` would."""
    import contextlib
    import io

    from sph_tpu_torch import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["run", "tutorial2d", "--frames", "1", "--quiet"])
    assert rc == 1 and len(err.getvalue().strip().splitlines()) == 1
    raise RuntimeError(err.getvalue())


@pytest.mark.parametrize("entry", ["cli", "init", "make_step",
                                   "make_advance", "prime", "run"])
def test_entry_points_raise_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = _scene()
    state = port.init(scene, device="cpu")
    calls = {
        "cli": lambda: _cli_without_a_card(),
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
    assert not any(slot_kernels.LAUNCHES.values())
    packed_kernels.reset_launches()
    state = port.run(_scene(), 4, method="pallas", packed_rows=True,
                     sort_every=2, state=state, device="cpu")
    assert int(state.step) == 7
    assert not any(packed_kernels.LAUNCHES.values())
    state = port.run(_scene(), 4, method="pallas", sort_every=2,
                     slot_resident=True, state=state, device="cpu")
    assert int(state.step) == 11
    assert not any(slot_kernels.LAUNCHES.values())
    stage_kernels.reset_launches()
    sg = tps.slot_grid(GridSpec.for_scene(_scene()))
    addr = tps.build_addr(state.x, state.active, GridSpec.for_scene(_scene()),
                          sg)
    tps.scatter_slots(addr, tps._pack_rows6(state.x, state.v), sg, staged=True)
    assert stage_kernels.LAUNCHES == {"stage_transpose": 0}


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
    assert not any(slot_kernels.LAUNCHES.values())
    packed_kernels.reset_launches()
    feat = torch.empty((3, 8, 256), device=m)
    jb = torch.empty((3,), dtype=torch.int32, device=m)
    gc = torch.empty((3, 1, 2), dtype=torch.int32, device=m)
    with pytest.raises(RuntimeError, match="nvcc"):
        packed_kernels.packed_density(feat, n_occ, nbr, jb, gc, p)
    with pytest.raises(RuntimeError, match="nvcc"):
        packed_kernels.packed_force(feat, torch.empty((3, 2, 256), device=m),
                                    n_occ, nbr, jb, gc, p)
    assert not any(packed_kernels.LAUNCHES.values())
    stage_kernels.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        stage_kernels.stage_transpose(torch.empty((3 * 256, 8), device=m), 3,
                                      256)
    assert stage_kernels.LAUNCHES == {"stage_transpose": 0}


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


# The slab fast path (reuse, resident, repair across slabs, ROADMAP.md
# Queue 1 item 14.3) gets past the option checks to the process-group
# check; pencils (item 14.4) check their two cut axes first.
OUT_OF_SLICE = {
    "slot_resident": lambda s: port.run(s, 4, "pallas", sort_every=4,
                                        slot_resident=True, shards=2,
                                        device="cpu"),
    "shards": lambda s: port.run(s, 4, "pallas", shards=(2, 2),
                                 shard_axis=1, device="cpu"),
    "shards_fast_path": lambda s: port.run(s, 4, "pallas", sort_every=4,
                                           shards=2, device="cpu"),
    "repair_k": lambda s: port.run(s, 4, "pallas", sort_every=4,
                                   slot_resident=True, repair_k=64, shards=2,
                                   device="cpu"),
}


@pytest.mark.parametrize("option", sorted(OUT_OF_SLICE))
def test_out_of_slice_options_raise(option):
    if option == "shards":
        # in 2D shard_axis2 defaults to the last axis, 1: shard_axis=1 collides
        with pytest.raises(ValueError,
                           match="shard_axis2 must differ from shard_axis"):
            OUT_OF_SLICE[option](_scene())
        return
    # the slab fast path's options are accepted: without a process group
    # the run asks for one, as the per-step slabs do
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        OUT_OF_SLICE[option](_scene())


def test_run_shards_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        port.run(_scene(), 4, "grid", shards=2, device="cpu")


def _bf16(s):
    return s.replace(params=s.params.replace(precision="bf16"))


# The options that were out of the slice until ROADMAP.md Queue 1 items 15
# (the kernel options), 16 (the cap-8 policy) and 6 (the grid method) were
# ported: each runs on the CPU now (each returns the state it reached, or
# the slot grid it made).
NOW_IN_SLICE = {
    "adaptive_cap": lambda s, st: port.run(s, 4, "pallas", adaptive_cap=True,
                                           state=st, device="cpu"),
    "audited_resident": lambda s, st: port.make_audited_advance(
        s, "pallas", 8, sort_every=4, slot_resident=True, adaptive_cap=True,
        device="cpu")(st),
    "grid": lambda s, st: port.make_step(s, "grid", device="cpu")(st),
    "resident_packed": lambda s, st: port.make_advance(
        s, "pallas", steps_per_dispatch=4, sort_every=4, slot_resident=True,
        auto_rebuild=True, packed_scatter=True, device="cpu")(st)[0],
    "row_pair": lambda s, st: port.make_step(s, "pallas", row_pair=True,
                                             device="cpu")(st),
    "xsub": lambda s, st: port.make_advance(
        s, "pallas", steps_per_dispatch=2, xsub=2, device="cpu")(st),
    "xsub_grid": lambda s, st: tps.slot_grid(GridSpec.for_scene(s, xsub=2)),
    "bf16": lambda s, st: port.make_step(_bf16(s), "pallas",
                                         device="cpu")(st),
}


@pytest.mark.parametrize("option", sorted(NOW_IN_SLICE))
def test_options_of_this_slice_run(option):
    scene = _scene()
    state = port.init(scene, device="cpu")
    out = NOW_IN_SLICE[option](scene, state)
    if option == "xsub_grid":
        assert (out.xsub, out.cap) == (2, GridSpec.for_scene(scene).cap // 2)
        return
    assert int(out.step) > 0 and bool(torch.isfinite(out.x).all())
    assert not torch.equal(out.x, state.x)


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        port.make_step(_scene(), "magic", device="cpu")
