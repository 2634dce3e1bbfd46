"""The reference's fuzz of the fast path's policies (tests/test_fuzz.py:79,
:105) through the port, on the same random scenes
(tests/torch_fuzz_scenes.py):

- resident == classic reuse (seeds 515, 616): the port's slot-resident
  block and its classic `sort_every=4` reuse are bitwise each other (x, v,
  rho, acc), and both violation counts equal the reference's;
- the auto policies (seeds 919, 1020): the membership-relaxed, strict and
  minority-repair advances of `make_audited_advance` (one 24-step
  dispatch) heal, repair, rebuild and end in the mode the reference's do,
  exactly; x within 1e-4 of the position scale of the port's exact
  per-step run, and of the reference's run of the same policy.

The same states go into both packages (the reference's init and prime,
tests/test_torch_resident.py's `_pair`).  The reference runs Pallas in
interpret mode, as its own tests do.
"""

import jax
import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu_torch as port
import torch_fuzz_scenes as fs
from sph_tpu import step as ref_step
from sph_tpu.step import make_advance as ref_make_advance
from test_torch_fuzz import X_REL, ref_scene_of
from test_torch_resident import CPU, _agree, _pair, _same

torch.set_num_threads(1)


def primed_pair(scene):
    """(reference scene, its state, the port's scene, the same state): the
    port scene's copy in the reference from init, primed on the pallas
    path under leapfrog as tests/test_fuzz.py primes it."""
    rs = ref_scene_of(scene)
    st = sph_tpu.init(rs)
    if rs.params.integrator == "leapfrog":
        st = jax.jit(lambda s: ref_step.prime(rs, s, method="pallas"))(st)
    return _pair(rs, st)


def x_within(xa, xb, act, what):
    """Positions `xa` within X_REL of `xb`'s scale on `act`."""
    xa, xb = xa[act], xb[act]
    scale = np.max(np.abs(xb)) + 1e-9
    assert np.all(np.isfinite(xa)), what
    assert np.max(np.abs(xa - xb)) / scale < X_REL, (what, np.max(
        np.abs(xa - xb)))


@pytest.mark.parametrize("seed", fs.RESIDENT_SEEDS)
def test_random_scene_resident_is_classic_reuse(seed):
    rs, rst, scene, ost = primed_pair(fs.scene_for(seed))
    kw = dict(steps_per_dispatch=8, sort_every=4)
    ref_a, viol_ra = ref_make_advance(rs, "pallas", **kw)(rst)
    ref_b, viol_rb = ref_make_advance(rs, "pallas", slot_resident=True,
                                      **kw)(rst)
    a, viol_a = port.make_advance(scene, "pallas", **kw, **CPU)(ost)
    b, viol_b = port.make_advance(scene, "pallas", slot_resident=True, **kw,
                                  **CPU)(ost)
    assert (int(viol_a), int(viol_b)) == (int(viol_ra), int(viol_rb)) \
        == (0, 0), scene.params
    _same(a, b, ("x", "v", "rho", "acc"))
    _agree(ref_b, b, f"resident {seed}")
    assert bool(torch.isfinite(b.x).all())


POLICIES = {
    "membership": dict(repair_k=0),
    "strict": dict(membership_audit=False, repair_k=0),
    "repair": dict(repair_k=128),
}


@pytest.mark.parametrize("seed", fs.POLICY_SEEDS)
def test_random_scene_auto_policies_match_reference(seed):
    """`make_advance`'s counters (viol, healed, rebuilds, repairs) against
    the reference's as tests/test_fuzz.py:105 makes them; the port's
    `make_audited_advance` of each policy counts the same and stays in the
    mode the reference's starts in, "resident" (sph_tpu/step.py:1884; it
    demotes only after DEMOTE_PATIENCE dispatches)."""
    rs, rst, scene, ost = primed_pair(fs.scene_for(seed))
    kw = dict(steps_per_dispatch=24, sort_every=4, slot_resident=True,
              auto_rebuild=True)
    exact = port.make_advance(scene, "pallas", steps_per_dispatch=24,
                              **CPU)(ost)
    act = exact.active.numpy()
    rebuilds = {}
    for name, knobs in POLICIES.items():
        ref = ref_make_advance(rs, "pallas", **kw, **knobs)(rst)
        ours = port.make_advance(scene, "pallas", **kw, **knobs, **CPU)(ost)
        want = tuple(int(n) for n in ref[1:])
        got = tuple(int(n) for n in ours[1:])
        assert got == want and want[0] == 0, (seed, name, got, want)
        assert np.array_equal(ours[0].active.numpy(), act)
        x_within(ours[0].x.numpy(), exact.x.numpy(), act, (seed, name))
        x_within(ours[0].x.numpy(), np.asarray(ref[0].x), act,
                 (seed, name, "ref"))
        audited = port.make_audited_advance(
            scene, "pallas", 24, sort_every=4, slot_resident=True, **knobs,
            **CPU)
        _same(audited(ost), ours[0], ("x", "v", "rho"))
        repaired = want[3] if len(want) > 3 else 0
        assert (audited.healed, audited.repaired, audited.rebuilds,
                audited.mode) == (want[1], repaired, want[2], "resident")
        rebuilds[name] = want[2]
    # the membership lemma only removes rebuild triggers (:130)
    assert rebuilds["membership"] <= rebuilds["strict"]
