"""Verlet-skin address reuse in the port (`sort_every > 1`, non-resident)
vs the reference's `make_advance(sort_every=)`, on the slot layout and on
packed rows, with the audited exact re-run and `run`'s dispatch plan.

The scene is the small emitter scene of `tests/test_packed_rows.py` (3D,
capacity 4096, one emitter whose first row activates at step 4, i.e. inside
the first 8-step window).  Bounds are the reference's own between its layouts: x
within 1e-3·h (test_packed_rows.py:158).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu_torch as port
from sph_tpu import neighbors as jnb
from sph_tpu.params import Block, Emitter
from sph_tpu.step import default_skin as ref_default_skin
from sph_tpu.step import make_advance as ref_make_advance
from sph_tpu.step import prime as ref_prime
from sph_tpu_torch import neighbors as tnb
from sph_tpu_torch.state import State

torch.set_num_threads(1)

FIELDS = ("x", "v", "acc", "rho", "p", "kind", "emit_step", "step")


def _emitter_scene():
    p = sph_tpu.SimParams(dim=3, kernel_norm="proper", boundary_mode="penalty",
                          gravity=(0.0, -9.81, 0.0))
    return sph_tpu.calibrate(sph_tpu.Scene(
        params=p,
        lo=(0.0,) * 3,
        hi=(240.0,) * 3,
        blocks=(Block(lo=(20.0,) * 3, hi=(90.0,) * 3),),
        emitters=(Emitter(pos=(150.0,) * 3, velocity=(0.0, -30.0, 0.0),
                          width=2, start_step=4),),
        capacity=4096,
        seed=40,
    ))


@functools.lru_cache(maxsize=None)
def _primed():
    """(reference scene, its primed init, the port's scene and the same
    state as a port State)."""
    ref_scene = _emitter_scene()
    ref = jax.jit(lambda s: ref_prime(ref_scene, s, method="pallas"))(
        sph_tpu.init(ref_scene))
    scene = port.scene_from_json(sph_tpu.scene_to_json(ref_scene))
    ours = State.from_numpy({f: getattr(ref, f) for f in FIELDS}, "cpu")
    return ref_scene, ref, scene, ours


def _kicked(ref_scene, ref):
    """Alternating-sign velocities that cross 3× the drift budget (skin/2)
    within one 4-step window, as the reference's own switch test kicks."""
    budget = ref_default_skin(ref_scene, 4) / 2.0
    kick = 3.0 * budget / (4 * ref_scene.params.dt)
    signs = np.where(np.arange(ref.capacity)[:, None] % 2 == 0, 1.0, -1.0)
    v = np.where(np.asarray(ref.active)[:, None], kick * signs, 0.0)
    return (v * np.ones((1, 3))).astype(np.float32)


@pytest.mark.parametrize("sort_every", [1, 4])
@pytest.mark.parametrize("name", port.preset_names())
def test_default_skin_and_skinned_grid_equal(name, sort_every):
    ref_scene, scene = sph_tpu.preset(name), port.preset(name)
    skin = port.default_skin(scene, sort_every)
    assert skin == ref_default_skin(ref_scene, sort_every)
    ours = tnb.GridSpec.for_scene(scene, skin=skin)
    ref = jnb.GridSpec.for_scene(ref_scene, skin=skin)
    assert (ours.lo, ours.cell, ours.shape, ours.cap, ours.xsub) == (
        ref.lo, ref.cell, ref.shape, ref.cap, ref.xsub)
    assert ours.cell == scene.params.h + skin


@pytest.mark.parametrize("packed_rows", [False, True], ids=["slot", "packed"])
def test_reuse_advance_matches_reference(packed_rows):
    ref_scene, ref, scene, ours = _primed()
    kw = dict(steps_per_dispatch=8, sort_every=4, packed_rows=packed_rows)
    ref2, viol_ref = ref_make_advance(ref_scene, "pallas", **kw)(ref)
    ours2, viol = port.make_advance(scene, "pallas", device="cpu", **kw)(ours)
    assert viol.dtype == torch.int32 and viol.shape == ()
    assert int(viol) == int(viol_ref) == 0
    assert int(ours2.step) == int(ref2.step) == 8
    n_active = int(ours2.n_active())
    assert n_active == int(ref2.n_active()) > int(ours.n_active())
    assert np.array_equal(ours2.active.numpy(), np.asarray(ref2.active))
    act = ours2.active.numpy()
    dx = np.abs(ours2.x.numpy()[act] - np.asarray(ref2.x)[act])
    assert dx.max() < 1e-3 * scene.params.h
    assert np.allclose(ours2.rho.numpy()[act], np.asarray(ref2.rho)[act],
                       rtol=1e-4)


def test_mid_block_activation_stays_out_of_pair_physics():
    """A particle that activates inside a reuse block has no slot until the
    next build: it moves ballistically and keeps rest density, where the
    per-step path gives it a pair density at once (the reference's contract,
    sph_tpu/step.py:1307-1310)."""
    _, _, scene, ours = _primed()
    # a block over steps 1..4: the emitter's first row activates for its
    # last step (emit_step == 4)
    start = ours.replace(step=ours.step + 1)
    kw = dict(steps_per_dispatch=4, device="cpu")
    out, viol = port.make_advance(scene, "pallas", sort_every=4,
                                  packed_rows=True, **kw)(start)
    exact = port.make_advance(scene, "pallas", **kw)(start)
    new = (out.active & ~start.active).numpy()
    assert new.sum() > 0 and int(viol) == 0
    rest = np.float32(scene.params.rest_density)
    assert np.all(out.rho.numpy()[new] == rest)
    assert np.all(exact.rho.numpy()[new] != rest)


def test_violations_counted_and_rerun_exactly(capsys):
    ref_scene, ref, scene, ours = _primed()
    v = _kicked(ref_scene, ref)
    ref_k = dataclasses.replace(ref, v=jax.numpy.asarray(v))
    ours_k = ours.replace(v=torch.from_numpy(v))
    _, viol_ref = ref_make_advance(ref_scene, "pallas", steps_per_dispatch=4,
                                   sort_every=4)(ref_k)
    _, viol = port.make_advance(scene, "pallas", steps_per_dispatch=4,
                                sort_every=4, device="cpu")(ours_k)
    assert int(viol_ref) > 0 and int(viol) > 0
    # strict audit counts at least what the membership-relaxed one does
    _, strict = port.make_advance(scene, "pallas", steps_per_dispatch=4,
                                  sort_every=4, membership_audit=False,
                                  device="cpu")(ours_k)
    assert int(strict) >= int(viol)

    audited = port.make_audited_advance(scene, "pallas", 4, sort_every=4,
                                        packed_rows=True, device="cpu")
    got = audited(ours_k)
    assert "re-ran exactly (per-step rebuild)" in capsys.readouterr().err
    want = port.make_advance(scene, "pallas", steps_per_dispatch=4,
                             device="cpu")(ours_k)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_audited_advance_keeps_a_clean_dispatch(capsys):
    _, _, scene, ours = _primed()
    kw = dict(sort_every=4, packed_rows=True, device="cpu")
    got = port.make_audited_advance(scene, "pallas", 4, **kw)(ours)
    assert capsys.readouterr().err == ""
    want, viol = port.make_advance(scene, "pallas", steps_per_dispatch=4,
                                   **kw)(ours)
    assert int(viol) == 0
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    # sort_every <= 1 is plain make_advance: it returns a State
    one = port.make_audited_advance(scene, "pallas", 2, device="cpu")(ours)
    assert isinstance(one, State) and int(one.step) == 2


def test_run_dispatch_plan_with_remainder():
    """10 steps at sort_every=4, steps_per_dispatch=8: one 8-step reuse
    dispatch, then a 2-step remainder that runs per step."""
    _, _, scene, ours = _primed()
    frames = []
    out = port.run(scene, 10, method="pallas", sort_every=4,
                   steps_per_dispatch=8, state=ours, packed_rows=True,
                   device="cpu", frame_callback=lambda s: frames.append(int(s.step)))
    assert int(out.step) == 10 and frames == [8, 10]
    assert torch.isfinite(out.x[out.active]).all()
    # steps_per_dispatch is rounded down to a multiple of sort_every, and a
    # remainder that is a multiple keeps the reuse path
    frames.clear()
    out = port.run(scene, 12, method="pallas", sort_every=4,
                   steps_per_dispatch=10, state=ours, device="cpu",
                   frame_callback=lambda s: frames.append(int(s.step)))
    assert int(out.step) == 12 and frames == [8, 12]


def test_reuse_gates():
    _, _, scene, _ = _primed()
    with pytest.raises(ValueError, match="requires method='pallas'"):
        port.make_advance(scene, "naive", sort_every=4, device="cpu")
    with pytest.raises(ValueError, match="multiple of sort_every"):
        port.make_advance(scene, "pallas", steps_per_dispatch=6, sort_every=4,
                          device="cpu")
    with pytest.raises(ValueError, match="skinned cells"):
        port.make_advance(scene, "pallas", steps_per_dispatch=4, sort_every=4,
                          grid=tnb.GridSpec.for_scene(scene), device="cpu")
