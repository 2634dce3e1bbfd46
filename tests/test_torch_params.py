"""Port params (`sph_tpu_torch.params`) vs the reference (`sph_tpu.params`):
presets equal field for field, scene JSON read by both packages, and the
calibrated mass exactly equal."""

import dataclasses

import pytest
import torch

import sph_tpu
import sph_tpu_torch as port
from helpers import small_scene

torch.set_num_threads(1)


def _as_dict(scene) -> dict:
    return dataclasses.asdict(scene)


@pytest.mark.parametrize("name", sph_tpu.preset_names())
def test_presets_equal_field_for_field(name):
    assert port.preset_names() == sph_tpu.preset_names()
    assert _as_dict(port.preset(name)) == _as_dict(sph_tpu.preset(name))


@pytest.mark.parametrize("name", sph_tpu.preset_names())
def test_scene_json_round_trips_between_packages(name):
    ref, ours = sph_tpu.preset(name), port.preset(name)
    assert port.scene_from_json(sph_tpu.scene_to_json(ref)) == ours
    assert sph_tpu.scene_from_json(port.scene_to_json(ours)) == ref
    assert port.scene_to_json(ours) == sph_tpu.scene_to_json(ref)
    assert port.SimParams.from_json(ref.params.to_json()) == ours.params
    assert type(ref.params).from_json(ours.params.to_json()) == ref.params


@pytest.mark.parametrize(
    "dim,kw",
    [(2, {}), (2, dict(kernel_norm="proper")), (3, dict(eos="tait")),
     (2, dict(h=12.0))],
)
def test_calibrate_mass_exactly_equal(dim, kw):
    ref = small_scene(dim=dim, **kw)
    raw = port.scene_from_json(
        sph_tpu.scene_to_json(ref.replace(params=ref.params.replace(mass=1.0)))
    )
    assert port.calibrate(raw).params.mass == ref.params.mass


def test_unknown_preset_raises():
    with pytest.raises(KeyError):
        port.preset("no_such_scene")
