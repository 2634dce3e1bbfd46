"""The slot kernels' options that are off by default, in the port, against
the reference `sph_tpu` on the same numpy inputs:

  * `xsub` (x-cell subdivision): every SlotAddr field (center included)
    exactly equal, per-particle ρ and f within the reference's own
    tolerances between its paths (rtol 1e-5 atol 1e-6; f max-relative
    3e-5, tests/test_xsub.py), resident == classic reuse bitwise in x and
    ρ, and the reference's slot-cell overflow count;
  * `row_pair`: c_rows padded even as the reference pads it, and results
    bitwise those without the option, per step and resident;
  * `packed_scatter` (the bf16-pair rebuild transport): pack2bf16 /
    unpack2bf16 and the packed scatter bitwise the reference's, the
    auto-rebuild advance with the transport against the reference's own
    (counters equal; x and ρ within rtol 1e-5 atol 1e-6, v as in
    tests/test_torch_resident.py), the transport within the reference's
    tolerance of the default advance
    (tests/test_pallas_equiv.py::test_packed_scatter_transport), and its
    flag gates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu_torch as port
from helpers import random_cloud, small_scene
from sph_tpu import neighbors as jnb
from sph_tpu import pallas_step as jps
from sph_tpu.params import Scene as JScene
from sph_tpu.params import SimParams as JSimParams
from sph_tpu.step import make_advance as ref_make_advance
from sph_tpu_torch import neighbors as tnb
from sph_tpu_torch import pallas_step as tps
from sph_tpu_torch.params import Scene, SimParams
from sph_tpu_torch.state import State

torch.set_num_threads(1)

STATE_FIELDS = ("x", "v", "acc", "rho", "p", "kind", "emit_step", "step")
ADDR_FIELDS = ("pos", "valid", "row_pos", "gcounts", "n_occ", "nbr_pos",
               "overflow", "row_code", "center")
CPU = dict(device="cpu")


def _cloud(dim, n=200, seed=51):
    x = random_cloud(n, dim, 0.0, 120.0, seed=seed)[0][:, :dim].astype(
        np.float32)
    v = np.random.default_rng(seed + 1).uniform(-5, 5, (n, dim)).astype(
        np.float32)
    active = np.ones(n, bool)
    active[int(0.9 * n):] = False
    return x, v, active


def _grids(dim, cap, xsub=1):
    kw = dict(dim=dim, gravity=(0.0,) * dim, kernel_norm="proper")
    box = dict(lo=(0.0,) * dim, hi=(120.0,) * dim)
    jp, tp = JSimParams(**kw), SimParams(**kw)
    jg = jnb.GridSpec.for_scene(JScene(params=jp, **box), cap=cap, xsub=xsub)
    tg = tnb.GridSpec.for_scene(Scene(params=tp, **box), cap=cap, xsub=xsub)
    return jp, tp, jg, tg


def _port_scene(ref_scene):
    return port.scene_from_json(sph_tpu.scene_to_json(ref_scene))


# --- xsub -------------------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("xsub", [2, 4])
def test_xsub_addr_and_results_match_reference(dim, xsub):
    x, v, active = _cloud(dim)
    jp, tp, jg, tg = _grids(dim, 64, xsub)
    xa, va, aa = map(jnp.asarray, (x, v, active))
    xt, vt, at = map(torch.from_numpy, (x, v, active))
    jsg, tsg = jps.slot_grid(jg), tps.slot_grid(tg)
    assert (tsg.cap, tsg.c_rows, tsg.lanes, tsg.n_groups) == (
        jsg.cap, jsg.c_rows, jsg.lanes, jsg.n_groups)
    ja = jps.build_addr(xa, aa, jg, jsg)
    ta = tps.build_addr(xt, at, tg, tsg)
    for k in ADDR_FIELDS:
        a, b = getattr(ta, k).numpy(), np.asarray(getattr(ja, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    rho_r, _, f_r = map(np.asarray, jps.pallas_rho_p_f(xa, va, aa, jp, jg))
    rho, _, f = tps.pallas_rho_p_f(xt, vt, at, tp, tg)
    assert np.allclose(rho.numpy(), rho_r, rtol=1e-5, atol=1e-6)
    assert np.max(np.abs(f.numpy() - f_r)) / (np.abs(f_r).max() + 1e-9) < 3e-5


def test_xsub_resident_bitwise_vs_classic_reuse():
    """tests/test_xsub.py::test_xsub_resident_bitwise_vs_classic_reuse on
    the port (3D leapfrog WCSPH): x, ρ bitwise."""
    scene = _port_scene(small_scene(
        dim=3, eos="tait", integrator="leapfrog", boundary_mode="penalty",
        dt=4e-4, seed=79))
    state = port.prime(scene, port.init(scene, **CPU), "pallas", **CPU)
    kw = dict(steps_per_dispatch=8, sort_every=4, xsub=2, **CPU)
    s_a, viol_a = port.make_advance(scene, "pallas", **kw)(state)
    s_b, viol_b = port.make_advance(scene, "pallas", slot_resident=True,
                                    **kw)(state)
    assert int(viol_a) == 0 and int(viol_b) == 0
    assert torch.equal(s_a.x, s_b.x) and torch.equal(s_a.rho, s_b.rho)
    assert torch.allclose(s_a.v, s_b.v, rtol=1e-5, atol=1e-5)


def test_xsub_slot_cap_overflow_reported():
    """Six particles in one slot-cell of cap 8 / xsub 2 = 4 slots: two
    overflow, as the reference counts them."""
    p = SimParams(dim=2, gravity=(0.0, 0.0))
    scene = Scene(params=p, lo=(0.0, 0.0), hi=(120.0, 120.0))
    grid = tnb.GridSpec.for_scene(scene, cap=8, xsub=2)
    sg = tps.slot_grid(grid)
    x = torch.tensor([[33.0 + 0.1 * i, 40.0] for i in range(6)])
    active = torch.ones(6, dtype=torch.bool)
    cell_over, row_over = tps.slot_overflow(x, active, grid, sg)
    assert int(cell_over) + int(row_over) == 2
    assert int(tps.build_addr(x, active, grid, sg).overflow) == 2


def test_xsub_grid_gates():
    scene = Scene(params=SimParams(dim=2, gravity=(0.0, 0.0)),
                  lo=(0.0, 0.0), hi=(120.0, 120.0))
    with pytest.raises(ValueError, match="divisible by xsub"):
        tps.slot_grid(tnb.GridSpec(lo=(0.0, 0.0), cell=16.0, shape=(8, 8),
                                   cap=12, xsub=8))
    with pytest.raises(ValueError, match="slot cap"):
        tps.slot_grid(tnb.GridSpec(lo=(0.0, 0.0), cell=16.0, shape=(8, 8),
                                   cap=24, xsub=2))
    sg = tps.slot_grid(tnb.GridSpec.for_scene(scene, cap=16, xsub=2))
    assert (sg.cap, sg.xsub) == (8, 2)


# --- row_pair ---------------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 3])
def test_row_pair_bitwise(dim):
    """tests/test_pallas_equiv.py::test_row_pair_bitwise on the port, and
    c_rows padded even exactly as the reference pads it."""
    x, v, active = _cloud(dim, n=220, seed=41)
    jp, tp, jg, tg = _grids(dim, 16)
    jsg = jps.slot_grid(jg, row_pair=True)
    tsg = tps.slot_grid(tg, row_pair=True)
    assert tsg.c_rows == jsg.c_rows and tsg.c_rows % 2 == 0
    assert tps.slot_grid(tg).c_rows in (tsg.c_rows, tsg.c_rows - 1)
    xt, vt, at = map(torch.from_numpy, (x, v, active))
    a = tps.pallas_rho_p_f(xt, vt, at, tp, tg)
    b = tps.pallas_rho_p_f(xt, vt, at, tp, tg, row_pair=True)
    for u, w in zip(a, b):
        assert torch.equal(u, w)


def test_row_pair_resident_bitwise():
    """tests/test_pallas_equiv.py::test_row_pair_resident_bitwise on the
    port, and the per-step advance with row_pair."""
    scene = _port_scene(small_scene(dim=2, seed=76))
    state = port.init(scene, **CPU)
    kw = dict(steps_per_dispatch=12, sort_every=4, slot_resident=True, **CPU)
    s_a, viol_a = port.make_advance(scene, "pallas", **kw)(state)
    s_b, viol_b = port.make_advance(scene, "pallas", row_pair=True,
                                    **kw)(state)
    assert int(viol_a) == 0 and int(viol_b) == 0
    for f in ("x", "v", "rho"):
        assert torch.equal(getattr(s_a, f), getattr(s_b, f)), f
    step_a = port.make_advance(scene, "pallas", steps_per_dispatch=3, **CPU)
    step_b = port.make_advance(scene, "pallas", steps_per_dispatch=3,
                               row_pair=True, **CPU)
    assert torch.equal(step_a(state).x, step_b(state).x)


# --- packed_scatter -----------------------------------------------------------


def test_pack2bf16_bitwise_reference():
    rng = np.random.default_rng(5)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)
         ).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    a[:4] = (0.0, -0.0, 1e18, 3.0e38)
    jp = np.asarray(jps.pack2bf16(jnp.asarray(a), jnp.asarray(b)))
    tp = tps.pack2bf16(torch.from_numpy(a), torch.from_numpy(b))
    assert tp.dtype == torch.float32
    assert np.array_equal(tp.numpy().view(np.uint32), jp.view(np.uint32))
    for u, w in zip(tps.unpack2bf16(tp), jps.unpack2bf16(jnp.asarray(jp))):
        assert np.array_equal(u.numpy().view(np.uint32),
                              np.asarray(w).view(np.uint32))


def test_scatter_slots_packed_bitwise_reference():
    x, v, active = _cloud(3)
    _, _, jg, tg = _grids(3, 16)
    jsg, tsg = jps.slot_grid(jg), tps.slot_grid(tg)
    ja = jps.build_addr(jnp.asarray(x), jnp.asarray(active), jg, jsg)
    ta = tps.build_addr(torch.from_numpy(x), torch.from_numpy(active), tg,
                        tsg)
    cols = [np.asarray(jps.pack2bf16(jnp.asarray(x[:, i]),
                                     jnp.asarray(v[:, i]))) for i in range(3)]
    rows = np.stack(cols + [active.astype(np.float32)], axis=1)
    bg = np.asarray([jps.pack2bf16(jnp.float32(1e18), jnp.float32(0.0))] * 3
                    + [0.0], np.float32)
    want = np.asarray(jps.scatter_slots_packed(ja, jnp.asarray(rows), jsg,
                                               jnp.asarray(bg)))
    got = tps.scatter_slots_packed(ta, torch.from_numpy(rows), tsg,
                                   torch.from_numpy(bg))
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dim,seed,spd", [(2, 96, 8), (3, 99, 4)])
def test_packed_scatter_advance_matches_reference(dim, seed, spd):
    """The auto-rebuild advance with the packed_scatter transport against
    the reference's on the same state, with no healed block (a heal would
    replace the transported block by the exact re-run).  The reference
    runs op by op (`jax.disable_jit`), each op rounding in its own dtype as
    the port's do (a bf16 rounding of x - center turns a fused 1-ulp fp32
    difference into a visible one; ROADMAP Queue 3 item 8)."""
    ref_scene = small_scene(dim=dim, seed=seed)
    ref_state = sph_tpu.init(ref_scene)
    scene = _port_scene(ref_scene)
    state = State.from_numpy(
        {f: np.asarray(getattr(ref_state, f)) for f in STATE_FIELDS}, "cpu")
    kw = dict(steps_per_dispatch=spd, sort_every=4, slot_resident=True,
              auto_rebuild=True, packed_scatter=True)
    with jax.disable_jit():
        ref = ref_make_advance(ref_scene, "pallas", **kw)(ref_state)
    ours = port.make_advance(scene, "pallas", **kw, **CPU)(state)
    assert (int(ours[1]), *ours[2:]) == tuple(int(c) for c in ref[1:])
    assert ours[2] == 0 and ours[3] >= 1        # none healed, transported
    ref, ours = ref[0], ours[0]
    for f in ("x", "rho"):
        assert np.allclose(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                           rtol=1e-5, atol=1e-6), f
    v_ref = np.asarray(ref.v)
    assert np.allclose(ours.v.numpy(), v_ref, rtol=1e-5,
                       atol=1e-6 * np.abs(v_ref).max())


@pytest.mark.parametrize("dim", [2, 3])
def test_packed_scatter_transport(dim):
    """tests/test_pallas_equiv.py::test_packed_scatter_transport on the
    port: counters equal to the default auto advance's, positions within
    0.1 cell and ρ within 5% (one bf16 round trip per rebuild), no phantom
    neighbor."""
    scene = _port_scene(small_scene(dim=dim, seed=99))
    state = port.init(scene, **CPU)
    kw = dict(steps_per_dispatch=8, sort_every=4, slot_resident=True,
              auto_rebuild=True, **CPU)
    s_ref, v0, h0, r0 = port.make_advance(scene, "pallas", **kw)(state)
    s_pk, v1, h1, r1 = port.make_advance(scene, "pallas", packed_scatter=True,
                                         **kw)(state)
    assert int(v1) == 0 and h1 == h0 and r1 == r0
    act = s_pk.emit_step <= 8
    assert torch.isfinite(s_pk.x[act]).all()
    cell = tnb.GridSpec.for_scene(scene).cell
    assert float((s_pk.x[act] - s_ref.x[act]).abs().max()) < 0.1 * cell
    assert torch.allclose(s_pk.rho[act], s_ref.rho[act], rtol=5e-2)
    assert not torch.equal(s_pk.x, s_ref.x)    # the transport did round


def test_packed_scatter_flag_validation():
    scene = _port_scene(small_scene(dim=2, seed=99))
    kw = dict(steps_per_dispatch=8, sort_every=4, slot_resident=True, **CPU)
    with pytest.raises(ValueError, match="requires auto_rebuild"):
        port.make_advance(scene, "pallas", packed_scatter=True, **kw)
    bf16 = scene.replace(params=scene.params.replace(precision="bf16"))
    with pytest.raises(ValueError, match="fp32 features only"):
        port.make_advance(bf16, "pallas", packed_scatter=True,
                          auto_rebuild=True, **kw)
    with pytest.raises(ValueError, match="packed_scatter"):
        port.make_advance(scene, "pallas", packed_scatter=True,
                          auto_rebuild=True, packed_rows=True, **kw)
