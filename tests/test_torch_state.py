"""Port state (`sph_tpu_torch.state`): `init` bitwise equal to
`sph_tpu.init` (both seed on the host with numpy), and states carried
between the packages with `State.from_numpy` / `State.to_numpy`."""

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
