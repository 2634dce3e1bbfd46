"""The benchmark's own seeded-state generator and plain reference, held to
the program on the CPU: the generator bit for bit, the reference within
fp32 rounding of the port's plain path over a few steps."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.reference.seed_state import FIELDS, seed_arrays
from benchmark.reference.sph import Reference, frame_scalars, pairs_within
from benchmark.tests.small import small_cell


def _scene(preset: str) -> dict:
    from sph_tpu_torch import params

    return json.loads(params.scene_to_json(params.preset(preset)))


@pytest.mark.parametrize("preset,seed", [
    ("tutorial2d", 3), ("fountain2d", 2**31 + 5), ("emitters3d", 11),
])
def test_seeded_state_is_the_programs(preset, seed):
    from sph_tpu_torch import params, state

    scene = dict(_scene(preset), seed=seed)
    want = state.init(params.scene_from_json(json.dumps(scene)),
                      device="cpu").to_numpy()
    got = seed_arrays(scene, seed)
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_seeded_state_of_the_small_splash():
    from sph_tpu_torch import params, state

    scene = dict(small_cell().config["scene"], seed=123456789012)
    want = state.init(params.scene_from_json(json.dumps(scene)),
                      device="cpu").to_numpy()
    got = seed_arrays(scene, scene["seed"])
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("dim", [2, 3])
def test_pairs_within_is_brute_force(dim):
    g = torch.Generator().manual_seed(dim)
    x = torch.rand(700, dim, generator=g) * 60.0
    act = torch.rand(700, generator=g) > 0.1
    i, j = pairs_within(x, act, 7.5, chunk=128)
    got = set(zip(i.tolist(), j.tolist()))
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    ok = (d2 < 7.5**2) & act[:, None] & act[None, :]
    want = set(map(tuple, torch.nonzero(ok).tolist()))
    assert got == want


def _plain_run(scene: dict, n: int, method: str):
    from sph_tpu_torch import params, state, step

    sc = params.scene_from_json(json.dumps(scene))
    st = state.init(sc, device="cpu")
    if sc.params.integrator == "leapfrog":
        st = step.prime(sc, st, method=method, device="cpu")
    st = step.make_advance(sc, method, n, device="cpu")(st)
    return st.to_numpy()


@pytest.mark.parametrize("preset,method,n", [
    ("tutorial2d", "naive", 20), ("dam2d_10k", "pallas", 10),
])
def test_reference_follows_the_plain_path(preset, method, n):
    scene = _scene(preset)
    want = _plain_run(scene, n, method)
    s0 = {f: torch.from_numpy(a) for f, a in seed_arrays(scene, scene["seed"]).items()}
    ref = Reference(scene, "cpu")
    if scene["params"]["integrator"] == "leapfrog":
        s0 = ref.prime(s0)
    got = {f: t.numpy() for f, t in ref.advance(s0, n).items()}
    act = want["emit_step"] <= want["step"]
    h = scene["params"]["h"]
    assert int(got["step"]) == int(want["step"]) == n
    assert np.abs(got["x"][act] - want["x"][act]).max() < 1e-4 * h
    assert np.abs(got["rho"][act] - want["rho"][act]).max() \
        < 1e-4 * scene["params"]["rest_density"]


def test_reference_follows_the_resident_path_in_3d():
    """The small splash on the production default, on the CPU."""
    from sph_tpu_torch import params, state, step

    cell = small_cell()
    scene = dict(cell.config["scene"], seed=99)
    sc = params.scene_from_json(json.dumps(scene))
    st = step.prime(sc, state.init(sc, device="cpu"), method="pallas",
                    device="cpu")
    adv = step.make_audited_advance(sc, "pallas", 16, sort_every=4,
                                    slot_resident=True, device="cpu")
    want = adv(st).to_numpy()
    ref = Reference(scene, "cpu")
    s0 = ref.prime({f: torch.from_numpy(a)
                    for f, a in seed_arrays(scene, 99).items()})
    got = {f: t.numpy() for f, t in ref.advance(s0, 16).items()}
    assert np.abs(got["x"] - want["x"]).max() < 1e-5 * scene["params"]["h"]
    assert np.abs(got["rho"] - want["rho"]).max() < 1e-4 * 1000.0


def test_resume_works_out_the_programs_acc():
    """Leapfrog's acc at the end of a frame of the small splash, from its
    positions and velocities alone."""
    from sph_tpu_torch import params, state, step

    scene = dict(small_cell().config["scene"], seed=5)
    sc = params.scene_from_json(json.dumps(scene))
    st = step.prime(sc, state.init(sc, device="cpu"), method="pallas",
                    device="cpu")
    adv = step.make_audited_advance(sc, "pallas", 8, sort_every=4,
                                    slot_resident=True, device="cpu")
    st = adv(adv(st))
    end = {f: getattr(st, f) for f in FIELDS}
    got = Reference(scene, "cpu").resume({**end, "acc": torch.zeros_like(st.acc)})
    scale = float(st.acc.norm(dim=1).max())
    assert float((got["acc"] - st.acc).norm(dim=1).max()) < 1e-5 * scale


def test_frame_scalars_are_the_programs_diagnostics():
    from sph_tpu_torch import diagnostics, params, state

    scene = dict(small_cell().config["scene"], seed=4)
    sc = params.scene_from_json(json.dumps(scene))
    st = state.init(sc, device="cpu")
    st = st.replace(v=torch.randn(st.v.shape, generator=torch.Generator()
                                  .manual_seed(0)))
    got = diagnostics.scalars_dict(diagnostics.scalar_pack(st, sc.params))
    want = frame_scalars({f: getattr(st, f) for f in FIELDS},
                         scene["params"]["mass"])
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5), k
