"""The port's naive step against the frozen NumPy oracle
(`tests/oracle_numpy.py`), as `tests/test_oracle.py` holds the reference.

20 full steps of a tutorial-style scene in the four configurations of
`test_oracle.py::test_full_step_trajectory_vs_oracle`, with that test's
bounds (x within 5e-4 of its scale, v within 5e-3) and its loop: the
oracle is re-locked to the port's state after every step so that errors
do not compound.  The scene comes from the reference's `small_scene`
through its JSON, and the oracle reads the reference's params.
"""

import numpy as np
import pytest
import torch

import oracle_numpy as oracle
import sph_tpu
import sph_tpu_torch as port
from helpers import pdict, small_scene
from sph_tpu_torch.step import make_step, prime

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "dim,integrator,boundary_mode",
    [
        (2, "euler", "clamp"),
        (2, "euler", "penalty"),
        (2, "leapfrog", "penalty"),
        (3, "leapfrog", "penalty"),
    ],
)
def test_full_step_trajectory_vs_oracle(dim, integrator, boundary_mode):
    ref_scene = small_scene(
        dim=dim, integrator=integrator, boundary_mode=boundary_mode, seed=3
    )
    scene = port.scene_from_json(sph_tpu.scene_to_json(ref_scene))
    state = port.init(scene, device="cpu")
    if integrator == "leapfrog":
        state = prime(scene, state, device="cpu")
    x = state.x.numpy().copy()
    v = state.v.numpy().copy()
    acc = state.acc.numpy().copy()
    active = state.active.numpy()
    kind = state.kind.numpy()
    pd = pdict(ref_scene.params)

    step = make_step(scene, "naive", device="cpu")
    for k in range(20):
        state = step(state)
        x, v, acc, rho_o, pr_o = oracle.step(
            x, v, acc, active, kind, ref_scene.lo, ref_scene.hi, pd
        )
        xs = state.x.numpy()[active]
        vs = state.v.numpy()[active]
        pos_scale = np.max(np.abs(x[active])) + 1e-6
        vel_scale = np.max(np.abs(v[active])) + 1e-3
        assert np.max(np.abs(xs - x[active])) / pos_scale < 5e-4, f"step {k}"
        assert np.max(np.abs(vs - v[active])) / vel_scale < 5e-3, f"step {k}"
        x[active] = xs
        v[active] = vs
        acc[active] = state.acc.numpy()[active]
