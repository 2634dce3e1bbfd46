"""Checkpoints of the port (`sph_tpu_torch.diagnostics`) against the
reference's, the committed settled emitters3d state, the packed-row
occupancy probe on it, and the slice as a whole: packed per-step steps from
that state, cut to a CPU size, in both packages.

Tolerances of the slice are the reference's own between its layouts
(tests/test_packed_rows.py:48-50, 158): x within 1e-3·h, rho rtol 1e-5
atol 1e-6.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu_torch as port
from sph_tpu import diagnostics as ref_diag
from sph_tpu.state import State as RefState
from sph_tpu.step import make_advance as ref_make_advance
from sph_tpu.step import packed_fits as ref_packed_fits
from sph_tpu_torch.state import INACTIVE, State, park_position

torch.set_num_threads(1)

FIELDS = ("x", "v", "acc", "rho", "p", "kind", "emit_step", "step")
SETTLED = Path(__file__).resolve().parents[1] / "bench" / ".settled_emitters3d_full.npz"


def _assert_bitwise(ours: dict, ref: dict):
    for f in FIELDS:
        a, b = np.asarray(ours[f]), np.asarray(ref[f])
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("name", ["fountain2d", "emitters3d"])
def test_checkpoint_written_by_reference_read_by_port(name, tmp_path):
    ref_scene = sph_tpu.preset(name)
    ref = sph_tpu.init(ref_scene)
    path = str(tmp_path / "ref.npz")
    ref_diag.save_checkpoint(path, ref, ref_scene)
    ours, scene = port.load_checkpoint(path, device="cpu")
    assert ours.device.type == "cpu"
    _assert_bitwise(ours.to_numpy(), {f: getattr(ref, f) for f in FIELDS})
    assert scene == port.preset(name)
    assert port.scene_to_json(scene) == sph_tpu.scene_to_json(ref_scene)


@pytest.mark.parametrize("name", ["fountain2d", "emitters3d"])
def test_checkpoint_written_by_port_read_by_reference(name, tmp_path):
    scene = port.preset(name)
    ours = port.init(scene, device="cpu")
    if scene.spawn_reserve:  # a state that differs from the seeded one
        ours, k = port.spawn(ours, scene, pos=(200.0, 300.0), n=32,
                             velocity=(10.0, -5.0))
        assert k == 32
    path = str(tmp_path / "port.npz")
    port.save_checkpoint(path, ours, scene)
    ref, ref_scene = ref_diag.load_checkpoint(path)
    _assert_bitwise({f: getattr(ref, f) for f in FIELDS}, ours.to_numpy())
    assert ref_scene == sph_tpu.preset(name)
    # and back again through the port: the same bits, the same file keys
    again, _ = port.load_checkpoint(path, device="cpu")
    assert all(torch.equal(getattr(again, f), getattr(ours, f)) for f in FIELDS)
    with np.load(path) as z:
        assert sorted(z.files) == sorted((*FIELDS, "__scene_json__"))


def test_load_checkpoint_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.load_checkpoint(str(SETTLED))


@functools.lru_cache(maxsize=None)
def _settled():
    return port.load_checkpoint(str(SETTLED), device="cpu")


def test_settled_emitters3d_loads():
    state, scene = _settled()
    assert int(state.step) == 260000
    assert int(state.n_active()) == 53944
    assert state.capacity == scene.capacity == 65536
    assert scene == port.preset("emitters3d")
    ref, ref_scene = ref_diag.load_checkpoint(str(SETTLED))
    _assert_bitwise(state.to_numpy(), {f: getattr(ref, f) for f in FIELDS})


@pytest.mark.parametrize("sort_every,fits", [(1, True), (4, False)])
def test_packed_fits_on_the_settled_state(sort_every, fits):
    state, scene = _settled()
    assert port.packed_fits(scene, state, sort_every=sort_every) is fits
    ref, ref_scene = ref_diag.load_checkpoint(str(SETTLED))
    assert ref_packed_fits(ref_scene, ref, sort_every=sort_every) is fits


def test_packed_fits_of_an_empty_state():
    scene = port.preset("emitters3d")
    state = port.init(scene, device="cpu")
    none = state.replace(emit_step=torch.full_like(state.emit_step, int(INACTIVE)))
    assert port.packed_fits(scene, none) is True
    assert port.step.PACKED_MAX_OCC == sph_tpu.step.PACKED_MAX_OCC


def _cut(state: State, scene, hi_x=200.0, hi_z=200.0, capacity=4096) -> dict:
    """The active particles of `state` with x < hi_x and z < hi_z as host
    arrays of a smaller capacity; the spare slots are parked and never
    activate."""
    a = state.to_numpy()
    keep = np.flatnonzero((a["emit_step"] <= a["step"])
                          & (a["x"][:, 0] < hi_x) & (a["x"][:, 2] < hi_z))
    assert 2000 < len(keep) <= capacity
    n_pad = capacity - len(keep)
    out = {f: a[f][keep] for f in FIELDS if f != "step"}
    out["x"] = np.concatenate(
        [out["x"], np.broadcast_to(park_position(scene), (n_pad, 3))]
    ).astype(np.float32)
    for f in ("v", "acc"):
        out[f] = np.concatenate([out[f], np.zeros((n_pad, 3), np.float32)])
    out["rho"] = np.concatenate(
        [out["rho"], np.full(n_pad, scene.params.rest_density, np.float32)])
    out["p"] = np.concatenate([out["p"], np.zeros(n_pad, np.float32)])
    out["kind"] = np.concatenate([out["kind"], np.zeros(n_pad, np.int32)])
    out["emit_step"] = np.concatenate(
        [out["emit_step"], np.full(n_pad, INACTIVE, np.int32)])
    out["step"] = a["step"]
    return out


def test_slice_packed_steps_from_the_cut_checkpoint():
    """The slice as a whole: checkpoint → packed addressing → K3/K4 (plain
    versions here, Pallas interpret mode in the reference) → integration,
    one step and four steps."""
    state, scene = _settled()
    ref_scene = sph_tpu.scene_from_json(port.scene_to_json(scene))
    arrays = _cut(state, scene)
    ours = State.from_numpy(arrays, "cpu")
    ref = RefState(**{f: jnp.asarray(arrays[f]) for f in FIELDS})
    n0 = int(ours.n_active())
    assert n0 == int(ref.n_active())
    h = scene.params.h
    step_ref = ref_make_advance(ref_scene, "pallas", steps_per_dispatch=1,
                                packed_rows=True)
    step = port.make_advance(scene, "pallas", steps_per_dispatch=1,
                             packed_rows=True, device="cpu")
    for k in range(4):
        ref, ours = step_ref(ref), step(ours)
        act = ours.active.numpy()
        assert np.array_equal(act, np.asarray(ref.active))
        assert int(ours.step) == int(ref.step) == 260001 + k
        dx = np.abs(ours.x.numpy()[act] - np.asarray(ref.x)[act])
        assert dx.max() < 1e-3 * h, k
        assert np.allclose(ours.rho.numpy()[act], np.asarray(ref.rho)[act],
                           rtol=1e-5, atol=1e-6), k
    assert int(ours.n_active()) == n0
    assert torch.isfinite(ours.x[ours.active]).all()
