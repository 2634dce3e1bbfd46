"""Diagnostics of the port (`sph_tpu_torch.diagnostics`: `scalar_pack`,
`Watchdog`, `SimulationDiverged`, `cfl_limit`, `validate_state`,
`inject_nan`, the checked step) against the reference's, on the same
states: the frame scalars within 1e-6 relative (of the momentum's scale for
the momentum, a sum that cancels), the same verdicts and the reference's
messages (tests/test_diagnostics.py:20-91, 569-627)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu_torch as port
from helpers import small_scene
from sph_tpu import diagnostics as ref_diag
from sph_tpu.params import Block as RefBlock
from sph_tpu.params import Emitter as RefEmitter
from sph_tpu.params import Scene as RefScene
from sph_tpu.params import SimParams as RefSimParams
from sph_tpu_torch import diagnostics
from test_torch_resident import CPU, _pair

torch.set_num_threads(1)


def _moving(seed=90, dim=2):
    """A reference/port pair a few steps into a dam break (moving, so every
    scalar is nonzero)."""
    rs = small_scene(dim=dim, seed=seed)
    rst = sph_tpu.make_advance(rs, "naive", steps_per_dispatch=5)(
        sph_tpu.init(rs))
    return _pair(rs, rst)


@pytest.mark.parametrize("dim", [2, 3])
def test_scalar_pack_matches_reference(dim):
    rs, rst, scene, ost = _moving(dim=dim)
    ours = diagnostics.scalars_dict(diagnostics.scalar_pack(ost, scene.params))
    ref = ref_diag.scalars_dict(ref_diag.scalar_pack(rst, rs.params))
    assert list(ours) == list(ref) == list(diagnostics.SCALARS)
    mom = scene.params.mass * ref["n_active"] * ref["max_speed"]
    for k, b in ref.items():
        scale = mom if k.startswith("momentum") else abs(b)
        assert abs(ours[k] - b) <= 1e-6 * scale, k
    assert ours["n_active"] == int(ost.n_active()) and ours["max_speed"] > 0


def test_watchdog_catches_injected_nan_within_one_frame():
    rs, rst, scene, ost = _moving(seed=91)
    adv = port.make_advance(scene, "naive", steps_per_dispatch=5, **CPU)
    ref_adv = sph_tpu.make_advance(rs, "naive", steps_per_dispatch=5)
    wd = diagnostics.Watchdog(scene.params)
    wd.check(diagnostics.scalar_pack(adv(ost), scene.params))   # healthy
    bad = adv(diagnostics.inject_nan(ost, k=3))
    ref_bad = ref_adv(ref_diag.inject_nan(rst, k=3))
    assert np.isnan(bad.x[:3].numpy()).all()
    with pytest.raises(diagnostics.SimulationDiverged) as got:
        wd.check(diagnostics.scalar_pack(bad, scene.params))
    with pytest.raises(ref_diag.SimulationDiverged) as want:
        ref_diag.Watchdog(rs.params).check(
            ref_diag.scalar_pack(ref_bad, rs.params))
    assert str(got.value) == str(want.value)
    assert got.value.scalars["n_active"] == want.value.scalars["n_active"]
    # exploding but finite: the density and speed bounds
    hot = ost.replace(rho=ost.rho * 1000.0)
    with pytest.raises(diagnostics.SimulationDiverged, match="max_rho"):
        wd.check(diagnostics.scalar_pack(hot, scene.params))
    fast = diagnostics.Watchdog(scene.params, speed_limit=1e-3)
    with pytest.raises(diagnostics.SimulationDiverged, match="max_speed"):
        fast.check(diagnostics.scalar_pack(ost, scene.params))


def test_watchdog_tolerates_an_empty_frame():
    rs = sph_tpu.calibrate(RefScene(
        params=RefSimParams(), blocks=(),
        emitters=(RefEmitter(pos=(400.0, 500.0), velocity=(0.0, -50.0),
                             start_step=50),),
        capacity=256))
    rs, rst, scene, ost = _pair(rs)
    assert int(ost.n_active()) == 0
    pack = diagnostics.scalar_pack(ost, scene.params)
    s = diagnostics.Watchdog(scene.params).check(pack)
    ref = ref_diag.scalars_dict(ref_diag.scalar_pack(rst, rs.params))
    assert s == ref and s["n_active"] == 0 and s["min_rho"] == np.inf


def test_cfl_limit_and_validate_state():
    rs, rst, scene, ost = _moving(seed=92)
    p = scene.params
    assert diagnostics.cfl_limit(p, 0.0) is None
    assert diagnostics.cfl_limit(p, 100.0) == ref_diag.cfl_limit(rs.params,
                                                                 100.0)
    assert diagnostics.validate_state(ost, scene) == []
    far = ost.x.clone()
    far[0] = 1e7
    bad = diagnostics.inject_nan(ost.replace(x=far, rho=ost.rho * 1e3), k=0)
    ref_bad = dataclasses.replace(rst, x=jnp.asarray(far.numpy()),
                                  rho=rst.rho * 1e3)
    got = diagnostics.validate_state(bad, scene)
    assert got == ref_diag.validate_state(ref_bad, rs)
    assert "active particles far outside the domain" in got
    nan = diagnostics.inject_nan(ost, k=2)
    assert diagnostics.validate_state(nan, scene) == ["non-finite positions"]


def _checked_pair(rs, state_edit=None):
    """Run one checked step of each package on the same (edited) state:
    (port message or None, reference message or None)."""
    rs, rst, scene, ost = _pair(rs)
    if state_edit is not None:
        rst, ost = state_edit(rst, ost)
    err, _ = jax.jit(ref_diag.make_checked_step(rs, "grid"))(rst)
    try:
        err.throw()
        want = None
    except Exception as e:           # checkify's JaxRuntimeError
        want = str(e)
    try:
        out = diagnostics.make_checked_step(scene, "grid", **CPU)(ost)
        got = None
        assert int(out.step) == 1
    except diagnostics.CheckFailed as e:
        got = str(e)
    return got, want


def _nan(rst, ost):
    return ref_diag.inject_nan(rst, k=3), diagnostics.inject_nan(ost, k=3)


def _escaped(rst, ost):
    x = ost.x.clone()
    x[0] = torch.tensor([1e7, 1e7])
    return dataclasses.replace(rst, x=jnp.asarray(x.numpy())), ost.replace(x=x)


def _crammed():
    p = RefSimParams(boundary_mode="clamp")
    return sph_tpu.calibrate(RefScene(
        params=p, lo=(0.0, 0.0), hi=(400.0, 400.0),
        blocks=(RefBlock(lo=(100.0, 100.0), hi=(106.0, 106.0)),),
        spacing=0.4, grid_cap=8, seed=93))


@pytest.mark.parametrize("case", ["healthy", "nan", "out_of_bounds",
                                  "cap_overflow"])
def test_checked_step_matches_reference(case):
    scene, edit, want_msg = {
        "healthy": (small_scene(dim=2, seed=90), None, None),
        "nan": (small_scene(dim=2, seed=91), _nan,
                "non-finite active position"),
        "out_of_bounds": (small_scene(dim=2, seed=92), _escaped,
                          "out of grid bounds"),
        "cap_overflow": (_crammed(), None, "cell tile overflow"),
    }[case]
    got, want = _checked_pair(scene, edit)
    if want_msg is None:
        assert got is None and want is None
        return
    assert want_msg in got and want_msg in want
    # the reference's message, checkify's location suffix aside
    assert want.startswith(got), (got, want)
