"""Port trajectories (`sph_tpu_torch.run` / `make_advance`) vs the
reference's, from the same scene JSON and the same seeded init.

Bounds are the reference's own between its grid and Pallas paths
(test_pallas_equiv.py:99-102): x within 1e-4 of its scale, v within 1e-3.
"""

import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu_torch as port
from helpers import small_scene
from sph_tpu.step import make_advance as ref_make_advance
from sph_tpu.step import prime as ref_prime

torch.set_num_threads(1)

WCSPH_3D = dict(eos="tait", integrator="leapfrog", boundary_mode="penalty",
                dt=4e-4)


def _port_scene(ref_scene):
    return port.scene_from_json(sph_tpu.scene_to_json(ref_scene))


def _assert_locked(ref_state, ours, what):
    xr, vr = np.asarray(ref_state.x), np.asarray(ref_state.v)
    xo, vo = ours.x.numpy(), ours.v.numpy()
    assert np.max(np.abs(xr - xo)) / (np.max(np.abs(xr)) + 1e-6) < 1e-4, what
    assert np.max(np.abs(vr - vo)) / (np.max(np.abs(vr)) + 1e-3) < 1e-3, what
    assert np.array_equal(np.asarray(ref_state.step), ours.step.numpy()), what


@pytest.mark.parametrize(
    "dim,kw,method,dispatches,spd",
    [
        (2, {}, "naive", 3, 25),
        (2, {}, "grid", 3, 25),
        (2, {}, "pallas", 3, 25),
        (3, WCSPH_3D, "pallas", 2, 10),
    ],
    ids=["2d-naive", "2d-grid", "2d-pallas", "3d-wcsph-pallas"],
)
def test_trajectory_matches_reference(dim, kw, method, dispatches, spd):
    ref_scene = small_scene(dim=dim, seed=37, **kw)
    scene = _port_scene(ref_scene)
    ref = sph_tpu.init(ref_scene)
    ours = port.init(scene, device="cpu")
    if ref_scene.params.integrator == "leapfrog":
        ref = ref_prime(ref_scene, ref, method=method)
        ours = port.prime(scene, ours, method=method, device="cpu")
        _assert_locked(ref, ours, "prime")
        assert np.allclose(ours.acc.numpy(), np.asarray(ref.acc),
                           rtol=1e-3, atol=1e-2 * np.abs(np.asarray(ref.acc)).max())
    adv_ref = ref_make_advance(ref_scene, method, steps_per_dispatch=spd)
    adv = port.make_advance(scene, method, steps_per_dispatch=spd, device="cpu")
    for k in range(dispatches):
        ref, ours = adv_ref(ref), adv(ours)
        _assert_locked(ref, ours, f"dispatch {k}")


def test_run_matches_reference_run():
    """`run` end to end (init, prime, dispatch plan with a remainder) on
    leapfrog + Tait + penalty walls + pressure floor."""
    ref_scene = small_scene(dim=2, seed=39, integrator="leapfrog",
                            boundary_mode="penalty", eos="tait",
                            pressure_floor=True)
    ref = sph_tpu.run(ref_scene, 11, method="pallas", steps_per_dispatch=5)
    frames = []
    ours = port.run(_port_scene(ref_scene), 11, method="pallas",
                    steps_per_dispatch=5, device="cpu",
                    frame_callback=lambda s: frames.append(int(s.step)))
    assert frames == [5, 10, 11]
    _assert_locked(ref, ours, "run")


def test_dispatch_plan_is_bitwise_neutral():
    """S = 1 and S = 10 steps per dispatch give the same bits."""
    scene = _port_scene(small_scene(dim=2, seed=41))
    a = port.run(scene, 10, method="pallas", steps_per_dispatch=1, device="cpu")
    b = port.run(scene, 10, method="pallas", steps_per_dispatch=10, device="cpu")
    for f in ("x", "v", "acc", "rho", "p"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_force_fields_and_emitters_follow_reference():
    """A scene with scheduled force fields and an emitter (activation by
    emit_step; the reference turns on batch_skip for it, which changes no
    per-particle result) stays locked to the reference."""
    ref_scene = small_scene(dim=2, seed=43)
    ref_scene = ref_scene.replace(
        force_fields=(sph_tpu.ForceField(pos=(80.0, 120.0), strength=4e4,
                                         radius=60.0, start_step=2,
                                         stop_step=12),),
        emitters=(sph_tpu.Emitter(pos=(300.0, 300.0), velocity=(0.0, -80.0),
                                  width=2),),
        capacity=768,
    )
    ref = sph_tpu.run(ref_scene, 16, method="pallas", steps_per_dispatch=8)
    ours = port.run(_port_scene(ref_scene), 16, method="pallas",
                    steps_per_dispatch=8, device="cpu")
    assert int(ours.n_active()) == int(ref.n_active()) > 0
    _assert_locked(ref, ours, "fields+emitters")
