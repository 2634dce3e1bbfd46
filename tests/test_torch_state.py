"""Port state (`sph_tpu_torch.state`): `init` and `spawn` bitwise equal to
`sph_tpu.init` / `sph_tpu.spawn` (both work on the host with numpy), and
states carried between the packages with `State.from_numpy` /
`State.to_numpy`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu_torch as port
from sph_tpu_torch.state import INACTIVE, park_position

torch.set_num_threads(1)

FIELDS = ("x", "v", "acc", "rho", "p", "kind", "emit_step", "step")


def _ref_arrays(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


@pytest.mark.parametrize(
    "name", ["tutorial2d", "dam2d_10k", "emitters3d", "dam3d_100k"]
)
def test_init_bitwise_equal(name):
    ref = _ref_arrays(sph_tpu.init(sph_tpu.preset(name)))
    ours = port.init(port.preset(name), device="cpu").to_numpy()
    for f in FIELDS:
        assert ours[f].dtype == ref[f].dtype, f
        assert ours[f].shape == ref[f].shape, f
        assert np.array_equal(ours[f], ref[f]), f


def test_state_round_trip_between_packages():
    scene = sph_tpu.preset("emitters3d")
    ref = sph_tpu.init(scene)
    ours = port.State.from_numpy(
        {f: getattr(ref, f) for f in FIELDS}, device="cpu"
    )
    assert ours.device.type == "cpu" and ours.capacity == ref.capacity
    assert ours.dim == ref.dim == 3
    assert int(ours.n_active()) == int(ref.n_active())
    assert np.array_equal(ours.active.numpy(), np.asarray(ref.active))
    back = ours.to_numpy()
    for f, a in _ref_arrays(ref).items():
        assert back[f].dtype == a.dtype and np.array_equal(back[f], a), f
    again = port.State.from_numpy(back, device="cpu")
    assert all(torch.equal(getattr(again, f), getattr(ours, f)) for f in FIELDS)


def test_parked_and_never_active_slots():
    scene = port.preset("fountain2d")
    st = port.init(scene, device="cpu").to_numpy()
    never = st["emit_step"] == INACTIVE
    assert never.sum() >= scene.spawn_reserve
    pad = np.all(st["x"] == park_position(scene), axis=1)
    assert np.all(never[pad])


# name: (preset, spawn kwargs, steps taken first so that step + 1 != 1)
SPAWNS = {
    "2d": ("fountain2d", dict(pos=(200.0, 300.0), n=24), 0),
    "2d-velocity-radius": ("fountain2d", dict(pos=(400.0, 200.0), n=40,
                                              velocity=(30.0, -12.5),
                                              radius=60.0, seed=5), 3),
    "2d-near-wall": ("fountain2d", dict(pos=(2.0, 2.0), n=64), 0),
    "3d": ("emitters3d", dict(pos=(400.0, 300.0, 400.0), n=100,
                              velocity=(0.0, -20.0, 5.0), seed=2), 7),
    "too-little-capacity": ("fountain2d", dict(pos=(300.0, 300.0), n=100000,
                                               radius=2000.0), 0),
    "nothing-asked": ("fountain2d", dict(pos=(300.0, 300.0), n=0), 0),
}


@pytest.mark.parametrize("case", sorted(SPAWNS))
def test_spawn_bitwise_equal(case):
    name, kw, step = SPAWNS[case]
    ref_scene, scene = sph_tpu.preset(name), port.preset(name)
    ref = sph_tpu.init(ref_scene)
    if name == "emitters3d":
        # the preset schedules every spare slot; free some as expired events
        es = np.asarray(ref.emit_step).copy()
        es[-500:] = INACTIVE
        ref = sph_tpu.State(**{**{f: getattr(ref, f) for f in FIELDS},
                               "emit_step": jnp.asarray(es)})
    ref = sph_tpu.State(**{**{f: getattr(ref, f) for f in FIELDS},
                           "step": jnp.int32(step)})
    ours = port.State.from_numpy({f: getattr(ref, f) for f in FIELDS}, "cpu")
    free = int((ours.emit_step == int(INACTIVE)).sum())
    ref2, k_ref = sph_tpu.spawn(ref, ref_scene, **kw)
    ours2, k = port.spawn(ours, scene, **kw)
    assert k == k_ref
    if case == "too-little-capacity":
        assert 0 < k == free < kw["n"]
    if case == "nothing-asked":
        assert k == 0 and ours2 is ours
    back = ours2.to_numpy()
    for f, a in _ref_arrays(ref2).items():
        assert back[f].dtype == a.dtype and back[f].shape == a.shape, f
        assert np.array_equal(back[f], a), f
    # the input state is left as it was, and the new slots activate next step
    assert np.array_equal(ours.emit_step.numpy(), np.asarray(ref.emit_step))
    assert int((ours2.emit_step == step + 1).sum()) >= k


def test_spawn_rejects_wrong_dimensions():
    scene = port.preset("fountain2d")
    state = port.init(scene, device="cpu")
    with pytest.raises(ValueError, match="spawn pos"):
        port.spawn(state, scene, pos=(1.0, 2.0, 3.0))
    with pytest.raises(ValueError, match="spawn velocity"):
        port.spawn(state, scene, pos=(100.0, 100.0), velocity=(1.0,))
