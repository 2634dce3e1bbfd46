"""The reference's full feature matrix fuzz (tests/test_fuzz.py:138)
through the port: static boundary particles (`kind == 1`), an emitter and
a force field in one random scene (seeds 717, 818;
tests/torch_fuzz_scenes.py `feature_scene`).  The port's naive, grid and
pallas rho and f agree with the reference's per particle on the seeded
state, at the tolerances of tests/test_torch_fuzz.py; then 12 grid steps
of both packages through the emitter's first activations: shapes kept,
the emitter fired, the boundary particles bitwise where they started, x
within 1e-4 of the reference's position scale.
"""

import numpy as np
import pytest
import torch

import torch_fuzz_scenes as fs
from test_torch_fuzz import grid_steps, hold_paths, started

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", fs.FEATURE_SEEDS)
def test_random_scene_full_feature_matrix_matches_reference(seed):
    scene, ost, rs, rst = started(fs.scene_for(seed), "grid")
    kind = ost.kind.numpy()
    assert (kind == 1).any() and scene.emitters and scene.force_fields
    hold_paths(scene, ost, rs, rst, seed)
    shapes = {f: tuple(getattr(ost, f).shape) for f in ("x", "v", "acc",
                                                         "rho", "p", "kind",
                                                         "emit_step")}
    x0 = ost.x.numpy().copy()
    out = grid_steps(scene, ost, rs, rst, 12)
    assert {f: tuple(getattr(out, f).shape) for f in shapes} == shapes
    # the emitter fired within the 12 steps, and no boundary particle moved
    assert int(out.n_active()) > int(ost.n_active())
    assert np.array_equal(out.x.numpy()[kind == 1], x0[kind == 1])
