"""`make_audited_advance`'s resident policies in the port — constant-heal
demotion with its re-probe, the packed-row auto policy with its packed →
slot switch — and `run`'s production default (`sort_every=4,
slot_resident=True`), against the reference's with the same dispatch plan:
modes and counters equal, per-particle agreement as in
tests/test_torch_resident.py (whose helpers this file uses).  The
reference's cases are tests/test_pallas_equiv.py:537-585 and
tests/test_packed_rows.py:200-260; the settled emitters3d checkpoint is cut
to a CPU size as tests/test_torch_diagnostics.py cuts it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import sph_tpu
import sph_tpu_torch as port
from helpers import small_scene
from sph_tpu import step as ref_step
from sph_tpu.params import Block, Emitter
from sph_tpu.state import State as RefState
from sph_tpu.step import make_audited_advance as ref_make_audited
from sph_tpu_torch import step as port_step
from sph_tpu_torch.state import State
from test_torch_diagnostics import _cut, _settled
from test_torch_resident import CPU, FIELDS, _agree, _pair, _same

torch.set_num_threads(1)


def _kick(st, scene, ref: bool):
    """Alternating-sign velocities 3× over the drift budget per 4 steps."""
    budget = ref_step.default_skin(scene, 4) / 2.0
    kick = 3.0 * budget / (4 * scene.params.dt)
    n, d = st.x.shape
    signs = np.where(np.arange(n)[:, None] % 2 == 0, 1.0, -1.0)
    act = np.asarray(st.active) if ref else st.active.numpy()
    v = (np.where(act[:, None], kick * signs, 0.0)
         * np.ones((1, d))).astype(np.float32)
    if ref:
        return dataclasses.replace(st, v=jnp.asarray(v))
    return st.replace(v=torch.from_numpy(v))


def _calm(st, ref: bool):
    if ref:
        return dataclasses.replace(st, v=jnp.zeros_like(st.v))
    return st.replace(v=torch.zeros_like(st.v))


def test_constant_heal_demotes_to_perstep(monkeypatch, capsys):
    monkeypatch.setattr(ref_step, "PERSTEP_REPROBE_EVERY", 2)
    monkeypatch.setattr(port_step, "PERSTEP_REPROBE_EVERY", 2)
    rs, rst, scene, ost = _pair(small_scene(dim=2, seed=17))
    ref_adv = ref_make_audited(rs, "pallas", 8, sort_every=4,
                               slot_resident=True)
    adv = port.make_audited_advance(scene, "pallas", 8, sort_every=4,
                                    slot_resident=True, **CPU)
    assert adv.mode == ref_adv.mode == "resident"
    plan = ["kick", "kick", "kick", "calm", "calm"]
    modes = ["resident", "perstep", "perstep", "perstep", "resident"]
    v_scale = 0.0   # the calm dispatches carry the kicked ones' rounding
    for k, (what, mode) in enumerate(zip(plan, modes)):
        if what == "kick":
            rst, ost = _kick(rst, rs, True), _kick(ost, rs, False)
        else:
            rst, ost = _calm(rst, True), _calm(ost, False)
        rst, ost = ref_adv(rst), adv(ost)
        assert adv.mode == ref_adv.mode == mode, k
        assert adv.healed == ref_adv.healed, k
        assert adv.repaired == ref_adv.repaired == 0, k
        v_scale = max(v_scale, float(np.abs(np.asarray(rst.v)).max()))
        _agree(rst, ost, f"dispatch {k}", v_scale)
    err = capsys.readouterr().err
    assert "sph_tpu_torch: flow outruns the Verlet drift budget" in err
    assert "demoting to the per-step path" in err
    assert "resuming the resident fast path" in err
    assert int(ost.step) == 40


def _emitter_scene(blocks=True):
    p = sph_tpu.SimParams(dim=3, kernel_norm="proper", boundary_mode="penalty",
                          gravity=(0.0, -9.81, 0.0))
    scene = sph_tpu.calibrate(sph_tpu.Scene(
        params=p, lo=(0.0,) * 3, hi=(240.0,) * 3,
        blocks=(Block(lo=(20.0,) * 3, hi=(90.0,) * 3),),
        emitters=(Emitter(pos=(150.0,) * 3, velocity=(0.0, -30.0, 0.0),
                          width=2, start_step=4),),
        capacity=4096, seed=40,
    ))
    return scene if blocks else dataclasses.replace(scene, blocks=())


def _primed(ref_scene):
    st = jax.jit(lambda s: ref_step.prime(ref_scene, s, method="pallas"))(
        sph_tpu.init(ref_scene))
    return _pair(ref_scene, st)


def test_packed_auto_policy_probe_and_switch(capsys):
    """A sparse spray probes packed; kicked past the drift budget, every
    block of the next dispatch heals and the policy switches to the slot
    layout for good.  A pool at rest occupancy probes the slot layout."""
    rs, rst, scene, ost = _primed(_emitter_scene(blocks=False))
    ref_adv = ref_make_audited(rs, "pallas", 8, sort_every=4,
                               slot_resident=True)
    adv = port.make_audited_advance(scene, "pallas", 8, sort_every=4,
                                    slot_resident=True, **CPU)
    assert adv.mode == "probe"
    rst, ost = ref_adv(rst), adv(ost)
    assert adv.mode == ref_adv.mode == "packed"
    _agree(rst, ost, "packed dispatch")
    rst, ost = ref_adv(_kick(rst, rs, True)), adv(_kick(ost, rs, False))
    assert adv.mode == ref_adv.mode == "slot"
    assert adv.healed == ref_adv.healed == 2
    _agree(rst, ost, "switching dispatch")
    assert "packed rows outgrown" in capsys.readouterr().err

    rs_d, rst_d, scene_d, ost_d = _primed(_emitter_scene())
    ref_d = ref_make_audited(rs_d, "pallas", 8, sort_every=4,
                             slot_resident=True)
    adv_d = port.make_audited_advance(scene_d, "pallas", 8, sort_every=4,
                                      slot_resident=True, **CPU)
    rst_d, ost_d = ref_d(rst_d), adv_d(ost_d)
    assert adv_d.mode == ref_d.mode == "slot"
    assert adv_d.healed == ref_d.healed
    assert adv_d.repaired == ref_d.repaired
    _agree(rst_d, ost_d, "slot dispatch")


def test_packed_resident_is_packed_reuse_bitwise():
    _, _, scene, ost = _primed(_emitter_scene())
    kw = dict(steps_per_dispatch=8, sort_every=4, packed_rows=True, **CPU)
    res, viol_r, healed = port.make_advance(scene, "pallas",
                                            slot_resident=True, heal=True,
                                            **kw)(ost)
    reuse, viol_u = port.make_advance(scene, "pallas", **kw)(ost)
    assert int(viol_r) == int(viol_u) == 0 and healed == 0
    _same(res, reuse, ("x", "v", "rho", "acc"))


def test_settled_emitters3d_cut_production_default():
    """The production default from a cut of the settled emitters3d
    checkpoint (as tests/test_torch_diagnostics.py cuts it): the packed
    auto policy's verdict, the counters and the state after one 8-step
    dispatch agree with the reference's."""
    state, scene = _settled()
    arrays = _cut(state, scene)
    ref_scene = sph_tpu.scene_from_json(port.scene_to_json(scene))
    ref = RefState(**{f: jnp.asarray(arrays[f]) for f in FIELDS})
    ours = State.from_numpy(arrays, "cpu")
    ref_adv = ref_make_audited(ref_scene, "pallas", 8, sort_every=4,
                               slot_resident=True)
    adv = port.make_audited_advance(scene, "pallas", 8, sort_every=4,
                                    slot_resident=True, **CPU)
    ref, ours = ref_adv(ref), adv(ours)
    assert adv.mode == ref_adv.mode
    assert adv.mode == ("packed" if port.packed_fits(scene, State.from_numpy(
        arrays, "cpu"), 4) else "slot")
    assert adv.healed == ref_adv.healed and adv.repaired == ref_adv.repaired
    act = ours.active.numpy()
    assert np.array_equal(act, np.asarray(ref.active))
    dx = np.abs(ours.x.numpy()[act] - np.asarray(ref.x)[act])
    assert dx.max() < 1e-3 * scene.params.h
    assert np.allclose(ours.rho.numpy()[act], np.asarray(ref.rho)[act],
                       rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# run: the production default end to end, and the gates
# ---------------------------------------------------------------------------


def test_run_production_default_matches_reference():
    """`run(..., sort_every=4, slot_resident=True)` with a remainder: one
    8-step resident dispatch, then 2 steps per step."""
    rs = small_scene(dim=2, seed=39, integrator="leapfrog",
                     boundary_mode="penalty", eos="tait")
    ref = sph_tpu.run(rs, 10, method="pallas", steps_per_dispatch=8,
                      sort_every=4, slot_resident=True)
    frames = []
    ours = port.run(port.scene_from_json(sph_tpu.scene_to_json(rs)), 10,
                    method="pallas", steps_per_dispatch=8, sort_every=4,
                    slot_resident=True, frame_callback=lambda s: frames.append(
                        int(s.step)), **CPU)
    assert frames == [8, 10]
    _agree(ref, ours)
