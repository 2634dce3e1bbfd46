"""Slot-resident advances of the port (`slot_resident=True`: the classic
resident block with and without heal, and the auto-rebuild advance with its
three rebuild predicates and heal) against the reference's, with the same
dispatch plan in both packages; the gates of `make_advance`.  The audited
policies and `run` are in tests/test_torch_policy.py, minority repair in
tests/test_torch_repair.py; both use the helpers here.

Counters (viol, healed, rebuilds) must be equal.  Per particle, x and rho
agree within rtol=1e-5, atol=1e-6 (tests/test_pallas_equiv.py:55); v within
rtol=1e-5 and an atol of 1e-6 times the largest speed of the run, because a
float32 velocity component that is a near-zero difference of large forces
carries the forces' rounding (summation orders differ), not its own.  The
port's own contracts — resident == non-resident reuse, heal == the exact
per-step re-run — are bitwise.  The reference's cases are those of
tests/test_pallas_equiv.py:285-785.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu_torch as port
from helpers import small_scene
from sph_tpu import step as ref_step
from sph_tpu.params import Block, Emitter
from sph_tpu.step import make_advance as ref_make_advance
from sph_tpu_torch import step as port_step
from sph_tpu_torch.state import State

torch.set_num_threads(1)

FIELDS = ("x", "v", "acc", "rho", "p", "kind", "emit_step", "step")
CPU = dict(device="cpu")


def _port_state(ref) -> State:
    return State.from_numpy({f: getattr(ref, f) for f in FIELDS}, "cpu")


def _pair(ref_scene, ref_state=None):
    """(reference scene, its state, the port's scene, the same state)."""
    if ref_state is None:
        ref_state = sph_tpu.init(ref_scene)
    scene = port.scene_from_json(sph_tpu.scene_to_json(ref_scene))
    return ref_scene, ref_state, scene, _port_state(ref_state)


def _agree(ref, ours, what="", v_scale=None):
    """Per-particle agreement (see the module docstring); `v_scale` is the
    largest speed of the run where the run was faster before its end."""
    assert np.array_equal(ours.active.numpy(), np.asarray(ref.active)), what
    assert int(ours.step) == int(ref.step), what
    for f in ("x", "rho"):
        a, b = np.asarray(getattr(ref, f)), getattr(ours, f).numpy()
        assert np.allclose(b, a, rtol=1e-5, atol=1e-6), (what, f)
    v_ref = np.asarray(ref.v)
    if v_scale is None:
        v_scale = np.abs(v_ref).max()
    assert np.allclose(ours.v.numpy(), v_ref, rtol=1e-5,
                       atol=1e-6 * v_scale), (what, "v")


def _same(a: State, b: State, fields=FIELDS):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _jet(base):
    return base.replace(blocks=(Block(lo=base.blocks[0].lo,
                                      hi=base.blocks[0].hi,
                                      velocity=(2000.0, 0.0)),))


def _emitting(base):
    return base.replace(
        emitters=(Emitter(pos=(200.0, 300.0), velocity=(0.0, -60.0),
                          width=3, start_step=5, stop_step=6),),
        capacity=int(sph_tpu.init(base).capacity) + 64,
    )


# ---------------------------------------------------------------------------
# The classic resident block
# ---------------------------------------------------------------------------


def test_slot_resident_bitwise_euler():
    rs, rst, scene, ost = _pair(small_scene(dim=2, seed=73))
    kw = dict(steps_per_dispatch=12, sort_every=4)
    ref, viol_r = ref_make_advance(rs, "pallas", slot_resident=True, **kw)(rst)
    ours, viol = port.make_advance(scene, "pallas", slot_resident=True,
                                   **kw, **CPU)(ost)
    reuse, viol_u = port.make_advance(scene, "pallas", **kw, **CPU)(ost)
    assert int(viol_r) == int(viol) == int(viol_u) == 0
    assert int(ours.step) == 12
    _agree(ref, ours)
    _same(ours, reuse, ("x", "v", "rho", "acc"))


def test_slot_resident_bitwise_leapfrog_3d():
    ref_scene = small_scene(dim=3, eos="tait", integrator="leapfrog",
                            boundary_mode="penalty", dt=4e-4, seed=74)
    primed = jax.jit(lambda s: ref_step.prime(ref_scene, s, method="pallas"))(
        sph_tpu.init(ref_scene))
    rs, rst, scene, ost = _pair(ref_scene, primed)
    kw = dict(steps_per_dispatch=8, sort_every=4)
    ref, viol_r = ref_make_advance(rs, "pallas", slot_resident=True, **kw)(rst)
    ours, viol = port.make_advance(scene, "pallas", slot_resident=True,
                                   **kw, **CPU)(ost)
    reuse, _ = port.make_advance(scene, "pallas", **kw, **CPU)(ost)
    assert int(viol_r) == int(viol) == 0
    _agree(ref, ours)
    # the reference's v differs by 1-2 ulp here (XLA contracts an fma one
    # way in one program and not the other); eager PyTorch does not
    _same(ours, reuse, ("x", "v", "rho", "acc"))


def test_heal_counts_and_noop_on_calm_scene():
    calm = small_scene(dim=2, seed=73)
    _, _, scene, ost = _pair(calm)
    kw = dict(steps_per_dispatch=12, sort_every=4, slot_resident=True, **CPU)
    healed_run = port.make_advance(scene, "pallas", heal=True, **kw)(ost)
    plain, _ = port.make_advance(scene, "pallas", **kw)(ost)
    assert int(healed_run[1]) == 0 and healed_run[2] == 0
    _same(healed_run[0], plain, ("x", "v"))

    rs, rst, jet, ost_j = _pair(_jet(calm))
    ref, viol_r, healed_r = ref_make_advance(
        rs, "pallas", heal=True, steps_per_dispatch=12, sort_every=4,
        slot_resident=True)(rst)
    ours, viol, healed = port.make_advance(jet, "pallas", heal=True,
                                           **kw)(ost_j)
    assert int(viol) == int(viol_r) == 0
    assert healed == int(healed_r) == 3
    _agree(ref, ours)
    exact = port.make_advance(jet, "pallas", steps_per_dispatch=12,
                              **CPU)(ost_j)
    _same(ours, exact)


# ---------------------------------------------------------------------------
# The auto-rebuild resident advance
# ---------------------------------------------------------------------------

AUTO_KW = dict(slot_resident=True, auto_rebuild=True)
AUTO = dict(sort_every=4, **AUTO_KW)


def _scene_of(seed, scene_kind):
    base = small_scene(dim=2, seed=seed)
    return {"calm": base, "jet": _jet(base),
            "emitting": _emitting(base)}[scene_kind]


@functools.lru_cache(maxsize=None)
def _ref_auto(seed, scene_kind, spd, extra):
    """(port scene, port state, the reference's auto advance of `spd`
    steps: its state and its counters (viol, healed, rebuilds))."""
    rs, rst, scene, ost = _pair(_scene_of(seed, scene_kind))
    out = ref_make_advance(rs, "pallas", steps_per_dispatch=spd, **AUTO,
                           **dict(extra))(rst)
    return scene, ost, out[0], tuple(int(c) for c in out[1:])


def _port_pair(seed, scene_kind):
    """(port scene, port init state) of `_scene_of`."""
    _, _, scene, ost = _pair(_scene_of(seed, scene_kind))
    return scene, ost


@pytest.mark.parametrize(
    "case,seed,scene_kind,spd,extra,want",
    [
        ("forced_every_block", 95, "calm", 16, (("rebuild_frac", 0.0),),
         (0, 0, 4)),
        ("reactive_theta0", 95, "calm", 16, (("reactive_theta", 0.0),),
         (0, 0, 4)),
        ("calm_stretches", 96, "calm", 32, (), None),
        ("jet_heals", 97, "jet", 12, (), None),
        ("emitter_activation", 98, "emitting", 24, (), None),
        ("strict_predictor", 96, "calm", 32,
         (("membership_audit", False),), None),
    ],
)
def test_auto_rebuild_matches_reference(case, seed, scene_kind, spd, extra,
                                        want):
    scene, ost, ref, ref_counts = _ref_auto(seed, scene_kind, spd, extra)
    out = port.make_advance(scene, "pallas", steps_per_dispatch=spd, **AUTO,
                            **dict(extra), **CPU)(ost)
    ours, counts = out[0], (int(out[1]), *out[2:])
    assert counts == ref_counts, case
    if want is not None:
        assert counts == want, case
    _agree(ref, ours, case)
    viol, healed, rebuilds = counts
    assert viol == 0
    if case == "calm_stretches":
        assert healed == 0 and rebuilds < spd // 4
    if case == "emitter_activation":
        assert int(ours.n_active()) > int(ost.n_active()) and rebuilds >= 2


@pytest.mark.parametrize("knob", ["rebuild_frac", "reactive_theta"])
def test_auto_rebuild_every_block_is_the_classic_block_bitwise(knob):
    """Forced to rebuild at every block top, the auto advance IS the
    classic resident block (materialize ∘ enter_slots round-trips
    bitwise)."""
    scene, ost = _port_pair(95, "calm")
    kw = dict(steps_per_dispatch=16, sort_every=4, slot_resident=True, **CPU)
    auto = port.make_advance(scene, "pallas", auto_rebuild=True,
                             **{knob: 0.0}, **kw)(ost)
    classic, _ = port.make_advance(scene, "pallas", **kw)(ost)
    assert auto[2:] == (0, 4)
    _same(auto[0], classic, ("x", "v", "rho", "acc", "step"))


def test_auto_rebuild_heal_is_the_exact_rerun_bitwise():
    scene, ost = _port_pair(97, "jet")
    out = port.make_advance(scene, "pallas", steps_per_dispatch=12, **AUTO,
                            **CPU)(ost)
    assert out[2] == 3
    exact = port.make_advance(scene, "pallas", steps_per_dispatch=12,
                              **CPU)(ost)
    _same(out[0], exact)


def test_block_decisions_are_batched_into_few_fetches():
    """A calm dispatch fetches once per block plus once for its first
    `need`; a heal costs one more fetch (the fresh carry's `need`)."""
    scene, ost = _port_pair(96, "calm")
    port_step.reset_fetches()
    out = port.make_advance(scene, "pallas", steps_per_dispatch=32, **AUTO,
                            **CPU)(ost)
    assert out[2] == 0
    assert port_step.FETCHES == {"blocks": 8, "fetches": 9}
    jet_scene, ost_j = _port_pair(97, "jet")
    port_step.reset_fetches()
    out = port.make_advance(jet_scene, "pallas", steps_per_dispatch=12,
                            **AUTO, **CPU)(ost_j)
    assert out[2] == 3
    # 3 blocks + the first need + one fresh need after each of the two
    # heals that are not the last block's
    assert port_step.FETCHES == {"blocks": 3, "fetches": 6}


def test_resident_gates():
    scene = port.scene_from_json(sph_tpu.scene_to_json(small_scene(dim=2)))
    kw = dict(steps_per_dispatch=8, **CPU)
    with pytest.raises(ValueError, match="slot_resident requires"):
        port.make_advance(scene, "pallas", slot_resident=True, **kw)
    with pytest.raises(ValueError, match="heal requires"):
        port.make_advance(scene, "pallas", sort_every=4, heal=True, **kw)
    with pytest.raises(ValueError, match="auto_rebuild requires"):
        port.make_advance(scene, "pallas", sort_every=4, auto_rebuild=True,
                          **kw)
    with pytest.raises(ValueError, match="packed_scatter"):
        port.make_advance(scene, "pallas", sort_every=4, slot_resident=True,
                          packed_scatter=True, **kw)
    bf16 = scene.replace(params=scene.params.replace(precision="bf16"))
    with pytest.raises(ValueError, match="fp32 features only"):
        port.make_advance(bf16, "pallas", sort_every=4, **AUTO_KW,
                          packed_scatter=True, **kw)
    with pytest.raises(ValueError, match="repair_k does not support"):
        port.make_advance(bf16, "pallas", sort_every=4, **AUTO_KW,
                          repair_k=8, **kw)
    with pytest.raises(ValueError, match="repair_k requires"):
        port.make_advance(scene, "pallas", sort_every=4, **AUTO_KW,
                          repair_k=8, membership_audit=False, **kw)
    with pytest.raises(ValueError, match="membership predicate only"):
        port.make_advance(scene, "pallas", sort_every=4, **AUTO_KW,
                          repair_k=8, reactive_theta=0.5, **kw)
    with pytest.raises(ValueError, match="minority slot repair"):
        port.make_advance(scene, "pallas", sort_every=4, **AUTO_KW,
                          packed_rows=True, repair_k=8, **kw)
    # the cap-8 policy (Queue 1 item 16) is ported: it builds and runs
    adv = port.make_audited_advance(scene, "pallas", 8, sort_every=4,
                                    slot_resident=True, adaptive_cap=True,
                                    **CPU)
    assert adv.mode == "cap8"
    out = adv(port.init(scene, **CPU))
    assert int(out.step) == 8 and adv.mode == "cap8" and adv.skin is not None

