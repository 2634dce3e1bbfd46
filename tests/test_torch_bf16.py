"""precision="bf16" in the port: bf16 cell-relative features through K1/K2
(`sph_tpu_torch.slot_kernels`, plain versions on the CPU) on the per-step,
reuse and resident paths, against the reference `sph_tpu` on the same numpy
inputs (its Pallas kernels in interpret mode).

  * `SlotAddr.center`, the bf16 feature rows and the scattered bf16 slot
    arrays are bitwise the reference's; `slot_centers` is bitwise `center`;
  * per particle, ρ and p within rtol=1e-5, atol=1e-6 of the reference, and
    f within rtol=1e-5 and an atol of 1e-6 times the force scale (a force
    component that is a near-zero difference of large pair terms carries
    their rounding, and summation orders differ);
  * the port's versions of tests/test_bf16.py: bf16 against fp32 loosely,
    the exact self pair, resident == classic reuse bitwise, the trajectory
    against fp32; and the port's bf16 resident trajectory against the
    reference's (x and ρ rtol 1e-5 atol 1e-6, v as ROADMAP.md Queue 3
    item 7 says: atol 1e-6 times the run's largest speed).
"""

import functools

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
from sph_tpu_torch import step as port_step
from sph_tpu_torch.params import Scene, SimParams
from sph_tpu_torch.state import State

torch.set_num_threads(1)

ADDR_FIELDS = ("pos", "valid", "row_pos", "gcounts", "n_occ", "nbr_pos",
               "overflow", "row_code", "center")
CPU = dict(device="cpu")
STATE_FIELDS = ("x", "v", "acc", "rho", "p", "kind", "emit_step", "step")


def _cloud(dim, n=200, seed=41):
    x = random_cloud(n, dim, 0.0, 120.0, seed=seed)[0][:, :dim].astype(
        np.float32)
    v = np.random.default_rng(seed + 1).uniform(-5, 5, (n, dim)).astype(
        np.float32)
    active = np.ones(n, bool)
    active[int(0.9 * n):] = False
    return x, v, active


def _grids(dim, cap, xsub=1, **kw):
    kw = dict(dim=dim, gravity=(0.0,) * dim, kernel_norm="proper",
              precision="bf16", **kw)
    box = dict(lo=(0.0,) * dim, hi=(120.0,) * dim)
    jp, tp = JSimParams(**kw), SimParams(**kw)
    jg = jnb.GridSpec.for_scene(JScene(params=jp, **box), cap=cap, xsub=xsub)
    tg = tnb.GridSpec.for_scene(Scene(params=tp, **box), cap=cap, xsub=xsub)
    return jp, tp, jg, tg


@functools.lru_cache(maxsize=None)
def _case(dim, cap):
    """The reference's and the port's bf16 slot arrays and results."""
    x, v, active = _cloud(dim)
    jp, tp, jg, tg = _grids(dim, cap)
    xa, va, aa = map(jnp.asarray, (x, v, active))
    jsg = jps.slot_grid(jg)
    ja = jps.build_addr(xa, aa, jg, jsg)
    jrows = jps._rel_rows(xa, va, ja)
    jfeat = jps.scatter_slots(ja, jrows, jsg)
    ref = dict(addr={k: np.asarray(getattr(ja, k)) for k in ADDR_FIELDS},
               rows=np.asarray(jrows), feat=np.asarray(jfeat),
               whole=[np.asarray(a) for a in
                      jps.pallas_rho_p_f(xa, va, aa, jp, jg)])
    xt, vt, at = map(torch.from_numpy, (x, v, active))
    tsg = tps.slot_grid(tg)
    ta = tps.build_addr(xt, at, tg, tsg)
    trows = tps._rel_rows(xt, vt, ta)
    ours = dict(sg=tsg, addr=ta, rows=trows,
                feat=tps.scatter_slots(ta, trows, tsg),
                whole=tps.pallas_rho_p_f(xt, vt, at, tp, tg))
    return ref, ours, tp


def _bits(a) -> np.ndarray:
    """bf16 values as their uint16 bits (numpy or torch)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("dim,cap", [(2, 64), (3, 64), (3, 16)])
def test_bf16_feat_and_center_bitwise(dim, cap):
    ref, ours, _ = _case(dim, cap)
    for k in ADDR_FIELDS:
        a, b = getattr(ours["addr"], k).numpy(), ref["addr"][k]
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert ours["rows"].dtype == torch.bfloat16
    assert np.array_equal(_bits(ours["rows"]), _bits(ref["rows"]))
    assert ours["feat"].dtype == torch.bfloat16
    assert np.array_equal(_bits(ours["feat"]), _bits(ref["feat"]))
    # the empty row rounds 1e18 to ≈9.98e17: still past the 1e17 test
    assert float(ours["feat"][0, 0, 0]) > 1e17


@pytest.mark.parametrize("dim,cap", [(2, 64), (3, 64), (3, 16)])
def test_bf16_rho_p_f_match_reference(dim, cap):
    ref, ours, tp = _case(dim, cap)
    (rho_r, p_r, f_r), (rho, p, f) = ref["whole"], ours["whole"]
    assert np.allclose(rho.numpy(), rho_r, rtol=1e-5, atol=1e-6)
    assert np.allclose(p.numpy(), p_r, rtol=1e-5, atol=1e-6)
    scale = np.abs(f_r).max()
    assert np.allclose(f.numpy(), f_r, rtol=1e-5, atol=1e-6 * scale)
    # the kernels' bf16 launches are counted apart, and never on the CPU
    assert port.slot_kernels.LAUNCHES["slot_density_bf16"] == 0


@pytest.mark.parametrize("dim", [2, 3])
def test_bf16_matches_fp32_loose(dim):
    """tests/test_bf16.py::test_bf16_matches_fp32_loose on the port: ρ
    within ~1%, forces within a few % of the fp32 force scale."""
    x, v, active = _cloud(dim)
    _, pbf, _, grid = _grids(dim, 64)
    p32 = pbf.replace(precision="fp32")
    xt, vt, at = map(torch.from_numpy, (x, v, active))
    rho_a, _, f_a = tps.pallas_rho_p_f(xt, vt, at, p32, grid)
    rho_b, _, f_b = tps.pallas_rho_p_f(xt, vt, at, pbf, grid)
    assert torch.isfinite(rho_b).all() and torch.isfinite(f_b).all()
    assert torch.allclose(rho_b, rho_a, rtol=2e-2)
    scale = float(f_a.abs().max()) + 1e-9
    assert float((f_b - f_a).abs().max()) / scale < 6e-2


def test_bf16_self_pair_exact():
    """An isolated particle's bf16 density is bitwise its fp32 one: the
    self pair reads the same stored value on both sides."""
    p32 = SimParams(dim=2, gravity=(0.0, 0.0), kernel_norm="proper")
    scene = Scene(params=p32, lo=(0.0, 0.0), hi=(120.0, 120.0))
    grid = tnb.GridSpec.for_scene(scene, cap=8)
    x = torch.tensor([[7.3, 9.1], [100.2, 101.7]])  # off center: rounds
    v, a = torch.zeros_like(x), torch.ones(2, dtype=torch.bool)
    rho32, _, _ = tps.pallas_rho_p_f(x, v, a, p32, grid)
    rhobf, _, _ = tps.pallas_rho_p_f(x, v, a, p32.replace(precision="bf16"),
                                     grid)
    assert torch.equal(rho32, rhobf)


def _bf16_scene(dim):
    if dim == 2:
        return small_scene(dim=2, seed=76, precision="bf16")
    return small_scene(dim=3, eos="tait", integrator="leapfrog",
                       boundary_mode="penalty", dt=4e-4, seed=77,
                       precision="bf16")


def _port_pair(ref_scene):
    scene = port.scene_from_json(sph_tpu.scene_to_json(ref_scene))
    return scene, port.init(scene, **CPU)


@pytest.mark.parametrize("dim", [2, 3])
def test_bf16_resident_bitwise_vs_classic_reuse(dim):
    """bf16 slot-resident == bf16 classic sort_every bitwise in x and ρ:
    both subtract the same build-time centers (`slot_centers` against
    `SlotAddr.center`) before the bf16 rounding."""
    scene, state = _port_pair(_bf16_scene(dim))
    if dim == 3:
        state = port.prime(scene, state, "pallas", **CPU)
    kw = dict(steps_per_dispatch=8, sort_every=4, **CPU)
    s_a, viol_a = port.make_advance(scene, "pallas", **kw)(state)
    s_b, viol_b = port.make_advance(scene, "pallas", slot_resident=True,
                                    **kw)(state)
    assert int(viol_a) == 0 and int(viol_b) == 0
    assert torch.equal(s_a.x, s_b.x) and torch.equal(s_a.rho, s_b.rho)
    assert torch.allclose(s_a.v, s_b.v, rtol=1e-5, atol=1e-5)


def test_bf16_trajectory_tracks_fp32():
    """A 12-step bf16 resident dam break stays finite and within 1.0 (h/16)
    of the fp32 one: a frame or offset bug would be off by whole cells."""
    scene32, state = _port_pair(small_scene(dim=2, seed=78))
    scenebf = scene32.replace(
        params=scene32.params.replace(precision="bf16"))
    kw = dict(steps_per_dispatch=12, sort_every=4, slot_resident=True, **CPU)
    s32, v32 = port.make_advance(scene32, "pallas", **kw)(state)
    sbf, vbf = port.make_advance(scenebf, "pallas", **kw)(state)
    assert int(v32) == 0 and int(vbf) == 0
    assert torch.isfinite(sbf.x).all()
    assert float((sbf.x - s32.x).abs().max()) < 1.0


def test_bf16_resident_trajectory_matches_reference():
    """The bf16 resident advance, 8 steps of the 2D dam break, against the
    reference's on the same state.  The reference runs op by op
    (`jax.disable_jit`), each op rounding in its own dtype as the port's
    do: compiled as one scan, XLA's fusions move roundings, and bf16's
    quantum turns a 1-ulp fp32 difference into a visible one (on this
    case the reference's jitted scan and its own per-step form differ by
    ~5e-4 in v after 4 steps)."""
    ref_scene = _bf16_scene(2)
    ref_state = sph_tpu.init(ref_scene)
    scene, _ = _port_pair(ref_scene)
    state = State.from_numpy(
        {f: np.asarray(getattr(ref_state, f)) for f in STATE_FIELDS}, "cpu")
    kw = dict(steps_per_dispatch=8, sort_every=4, slot_resident=True)
    with jax.disable_jit():
        ref, rv = ref_make_advance(ref_scene, "pallas", **kw)(ref_state)
    ours, ov = port.make_advance(scene, "pallas", **kw, **CPU)(state)
    assert int(rv) == int(ov) == 0
    for f in ("x", "rho"):
        assert np.allclose(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                           rtol=1e-5, atol=1e-6), f
    v_ref = np.asarray(ref.v)
    assert np.allclose(ours.v.numpy(), v_ref, rtol=1e-5,
                       atol=1e-6 * np.abs(v_ref).max())


@pytest.mark.parametrize("dim,xsub", [(2, 1), (3, 1), (3, 2)])
def test_slot_centers_equal_center(dim, xsub):
    """`_SlotPhysics.slot_centers` read at each particle's slot is bitwise
    its `SlotAddr.center` (the y/z centers come from the halo row code)."""
    x, _, active = _cloud(dim, seed=43)
    _, tp, _, tg = _grids(dim, 16, xsub=xsub)
    sg = tps.slot_grid(tg)
    xt, at = torch.from_numpy(x), torch.from_numpy(active)
    addr = tps.build_addr(xt, at, tg, sg)
    scene = Scene(params=tp, lo=(0.0,) * dim, hi=(120.0,) * dim)
    sp = port_step._SlotPhysics(scene, tg, sg, torch.device("cpu"))
    ok = addr.ok()
    got = sp.gather(sp.slot_centers(addr), dim, addr)
    assert int(ok.sum()) > 100
    assert torch.equal(got[ok], addr.center[ok])
