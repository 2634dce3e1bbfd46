"""The reference's live spawn fuzz (tests/test_fuzz.py:207) through the
port: random bursts spawned between the dispatches of the production
resident auto advance (`steps_per_dispatch=8, sort_every=4,
slot_resident=True, auto_rebuild=True`), the `--interact` flow.  On the
reference's seeds (919, 1020) and the port's own (`extend`ed scenes, with
their force fields and reserves; tests/torch_fuzz_scenes.py), each burst
spawns the reference's count, no dispatch leaves a violation, the active
count is the reference's, and x and rho agree per particle within the
resident tolerances (rtol 1e-5, atol 1e-6; ROADMAP Queue 3 "not a fault"
7), v within 1e-3 of its scale.

The same states go into both packages (the reference's init and prime).
The reference runs Pallas in interpret mode, as its own tests do.
"""

import numpy as np
import pytest
import torch

import sph_tpu_torch as port
import torch_fuzz_scenes as fs
from sph_tpu.state import spawn as ref_spawn
from sph_tpu.step import make_advance as ref_make_advance
from test_torch_fuzz_policy import primed_pair
from test_torch_resident import CPU

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", fs.SPAWN_SEEDS + fs.PORT_SEEDS)
def test_random_scene_live_spawn_matches_reference(seed):
    scene, bursts = fs.spawn_case(seed)
    rs, rst, scene, ost = primed_pair(scene)
    n0 = int(ost.n_active())
    kw = dict(steps_per_dispatch=8, sort_every=4, slot_resident=True,
              auto_rebuild=True)
    ref_adv = ref_make_advance(rs, "pallas", **kw)
    adv = port.make_advance(scene, "pallas", **kw, **CPU)
    spawned, v_scale = 0, 0.0
    for b, burst in enumerate(bursts):
        rst, k_ref = ref_spawn(rst, rs, **burst)
        ost, k = port.spawn(ost, scene, **burst)
        assert k == k_ref > 0, (seed, b)
        # the same slots claimed, at bitwise the same positions
        emit = ost.emit_step.numpy()
        assert np.array_equal(emit, np.asarray(rst.emit_step))
        new = emit == int(ost.step) + 1
        assert int(new.sum()) == k
        assert np.array_equal(ost.x.numpy()[new], np.asarray(rst.x)[new])
        spawned += k
        ref_out, out = ref_adv(rst), adv(ost)
        rst, ost = ref_out[0], out[0]
        assert int(out[1]) == int(ref_out[1]) == 0, (seed, b)
        assert tuple(int(n) for n in out[2:]) == tuple(
            int(n) for n in ref_out[2:]), (seed, b)
        assert int(ost.n_active()) == int(rst.n_active()) == n0 + spawned
        act = ost.active.numpy()
        assert np.array_equal(act, np.asarray(rst.active))
        for f in ("x", "rho"):
            a, r = getattr(ost, f).numpy()[act], np.asarray(getattr(rst, f))[act]
            assert np.allclose(a, r, rtol=1e-5, atol=1e-6), (seed, b, f)
        v_ref = np.asarray(rst.v)[act]
        v_scale = max(v_scale, float(np.abs(v_ref).max()))
        assert np.abs(ost.v.numpy()[act] - v_ref).max() < 1e-3 * v_scale
    assert np.isfinite(ost.x.numpy()[ost.active.numpy()]).all()
