"""Port packed-row layout (`sph_tpu_torch.pallas_step` + `packed_kernels`)
vs the reference `sph_tpu.pallas_step`, whose packed Pallas kernels run in
interpret mode on the CPU as `tests/test_packed_rows.py` runs them.

On the clouds of the reference's own packed tests (test_packed_matches_grid
in 2D and 3D; test_packed_multiblock_and_overflow with row_lanes 384, where
rows hold more than 128 particles, and row_lanes 128, where rows overflow):

  * `packed_grid` is equal field for field;
  * every SlotAddr field and `_jblocks` are exactly equal;
  * per-particle (rho, p, f) of `pallas_rho_p_f(packed_rows=True)` agree
    with the reference's and with the port's own slot layout: rho rtol 1e-5
    atol 1e-6, f max-relative 3e-5 — the reference suite's tolerances
    between its own paths (test_packed_rows.py:23, 48-50), since summation
    orders differ; p within the rho tolerance carried through the EOS slope.

The CUDA kernels themselves are checked against the plain versions on a
card, by `tests/test_torch_gpu.py` and `chip_smoke.py`.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_tpu_torch as port
from sph_tpu import neighbors as jnb
from sph_tpu import pallas_step as jps
from sph_tpu.params import Scene as JScene
from sph_tpu.params import SimParams as JSimParams
from sph_tpu_torch import neighbors as tnb
from sph_tpu_torch import packed_kernels
from sph_tpu_torch import pallas_step as tps

torch.set_num_threads(1)

RHO_RTOL, RHO_ATOL, FTOL = 1e-5, 1e-6, 3e-5
ADDR_FIELDS = ("pos", "valid", "row_pos", "gcounts", "n_occ", "nbr_pos",
               "overflow", "row_code")


def _uniform(dim):
    n = 300
    rng = np.random.default_rng(7)
    x = rng.uniform(0.0, 120.0, (n, dim)).astype(np.float32)
    v = rng.uniform(-5, 5, (n, dim)).astype(np.float32)
    active = np.ones(n, bool)
    active[280:] = False
    return x, v, active, (0.0,) * dim, (120.0,) * dim, 16


def _tall():
    """520 particles in a narrow tall 2D box: rows of more than 128."""
    n = 520
    rng = np.random.default_rng(11)
    x = np.empty((n, 2), np.float32)
    x[:, 0] = rng.uniform(2, 40, n)
    x[:, 1] = rng.uniform(0, 400, n)
    v = rng.uniform(-5, 5, (n, 2)).astype(np.float32)
    active = np.ones(n, bool)
    active[500:] = False
    return x, v, active, (0.0, 0.0), (48.0, 400.0), 64


# name: (cloud, row_lanes (None = packed_grid's default))
CASES = {
    "uniform2d": (lambda: _uniform(2), None),
    "uniform3d": (lambda: _uniform(3), None),
    "multiblock2d": (_tall, 384),
    "row_overflow2d": (_tall, 128),
}


@functools.lru_cache(maxsize=None)
def _inputs(name):
    cloud, row_lanes = CASES[name]
    x, v, active, lo, hi, cap = cloud()
    dim = x.shape[1]
    kw = dict(dim=dim, gravity=(0.0,) * dim, kernel_norm="proper")
    jp, tp = JSimParams(**kw), port.SimParams(**kw)
    jg = jnb.GridSpec.for_scene(JScene(params=jp, lo=lo, hi=hi), cap=cap)
    tg = tnb.GridSpec.for_scene(port.Scene(params=tp, lo=lo, hi=hi), cap=cap)
    return x, v, active, jp, tp, jg, tg, row_lanes


@functools.lru_cache(maxsize=None)
def _reference(name):
    x, v, active, jp, _, jg, _, row_lanes = _inputs(name)
    xa, va, aa = jnp.asarray(x), jnp.asarray(v), jnp.asarray(active)
    sg = jps.packed_grid(jg, row_lanes)
    addr = jps.build_addr(xa, aa, jg, sg)
    whole = jps.pallas_rho_p_f(xa, va, aa, jp, jg, packed_rows=True,
                               row_lanes=row_lanes)
    return dict(
        sg=sg,
        addr={k: np.asarray(getattr(addr, k)) for k in ADDR_FIELDS},
        jb=np.asarray(jps._jblocks(addr, sg)),
        whole=tuple(np.asarray(a) for a in whole),
    )


def _rel_f(a, b):
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)


def _p_close(p, p_ref, rho, params) -> bool:
    """p within the rho tolerance carried through the (ideal) EOS slope
    (x2 for the rounding of the EOS itself)."""
    tol = (2.0 * params.stiffness * (RHO_ATOL + RHO_RTOL * np.abs(rho))
           + 1e-6 * np.abs(p_ref))
    return bool(np.all(np.abs(p - p_ref) <= tol))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("row_lanes", [None, 100, 640])
def test_packed_grid_equal_field_for_field(dim, row_lanes):
    _, _, _, _, _, jg, tg, _ = _inputs(f"uniform{dim}d")
    ref, ours = jps.packed_grid(jg, row_lanes), tps.packed_grid(tg, row_lanes)
    for k in ("inner", "cap", "c_rows", "packed", "row_lanes", "dim", "h0",
              "h1", "n_groups", "lanes", "row_offsets"):
        assert getattr(ours, k) == getattr(ref, k), k
    assert ours.packed and ours.lanes % tps.LANE == 0
    ref_c, ours_c = jps.packed_grid(jg, c_rows=3), tps.packed_grid(tg, c_rows=3)
    assert ours_c.c_rows == ref_c.c_rows == 4


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_addr_and_jblocks_exactly_equal(name):
    x, _, active, _, _, _, tg, row_lanes = _inputs(name)
    ref = _reference(name)
    sg = tps.packed_grid(tg, row_lanes)
    addr = tps.build_addr(torch.from_numpy(x), torch.from_numpy(active), tg, sg)
    for k in ADDR_FIELDS:
        a, b = getattr(addr, k).numpy(), ref["addr"][k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    jb = tps._jblocks(addr, sg).numpy()
    assert jb.dtype == ref["jb"].dtype and np.array_equal(jb, ref["jb"])
    assert jb[0] == 0  # the dummy row has no occupied block
    if name == "multiblock2d":
        assert jb.max() >= 2 and int(addr.overflow) == 0
    if name == "row_overflow2d":
        assert int(addr.overflow) == int(ref["addr"]["overflow"]) > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_packed_rho_p_f_matches_reference(name):
    x, v, active, _, tp, _, tg, row_lanes = _inputs(name)
    rho, p, f = tps.pallas_rho_p_f(
        *map(torch.from_numpy, (x, v, active)), tp, tg, packed_rows=True,
        row_lanes=row_lanes,
    )
    rho_r, p_r, f_r = _reference(name)["whole"]
    assert np.allclose(rho.numpy(), rho_r, rtol=RHO_RTOL, atol=RHO_ATOL)
    assert _p_close(p.numpy(), p_r, rho_r, tp)
    assert _rel_f(f.numpy(), f_r) < FTOL
    assert np.all(np.isfinite(f.numpy()))


@pytest.mark.parametrize("name", ["uniform2d", "uniform3d", "multiblock2d"])
def test_packed_matches_the_ports_slot_layout(name):
    """Without overflow both layouts hold every particle, so they compute
    the same sums in another order."""
    x, v, active, _, tp, _, tg, row_lanes = _inputs(name)
    args = (*map(torch.from_numpy, (x, v, active)), tp, tg)
    rho_p, p_p, f_p = tps.pallas_rho_p_f(*args, packed_rows=True,
                                         row_lanes=row_lanes)
    rho_s, p_s, f_s = tps.pallas_rho_p_f(*args)
    assert np.allclose(rho_p.numpy(), rho_s.numpy(), rtol=RHO_RTOL,
                       atol=RHO_ATOL)
    assert _p_close(p_p.numpy(), p_s.numpy(), rho_s.numpy(), tp)
    assert _rel_f(f_p.numpy(), f_s.numpy()) < FTOL


def test_packed_raw_arrays_zero_outside_live_lanes():
    """rp and f are zero on the dummy row, rows past n_occ and every lane
    without a particle; f's components >= D stay zero."""
    x, v, active, _, tp, _, tg, row_lanes = _inputs("multiblock2d")
    xt, vt, at = map(torch.from_numpy, (x, v, active))
    sg = tps.packed_grid(tg, row_lanes)
    addr = tps.build_addr(xt, at, tg, sg)
    feat = tps.scatter_slots(addr, tps._pack_rows6(xt, vt), sg)
    rp = tps._call_density(feat, addr, sg, tp)
    f = tps._call_force(feat, rp, addr, sg, tp)
    assert rp.shape == (sg.c_rows, 2, sg.lanes)
    assert f.shape == (sg.c_rows, tps.FOUT, sg.lanes)
    empty = feat[:, 0] >= 1e17
    n_occ = int(addr.n_occ[0])
    assert empty[0].all() and empty[n_occ + 1:].all()
    assert not rp[:, 0][empty].any() and not rp[:, 1][empty].any()
    assert (rp[:, 0][~empty] > 0).all()
    assert not f[:, 0][empty].any() and not f[:, tp.dim:].any()
    assert not any(packed_kernels.LAUNCHES.values())


def test_all_inactive_cloud():
    """n_occ == 0 (an emitter scene before its first activation): finite,
    rho = rest density, f = 0."""
    x, v, active, _, tp, _, tg, _ = _inputs("uniform3d")
    none = torch.zeros(len(active), dtype=torch.bool)
    sg = tps.packed_grid(tg)
    addr = tps.build_addr(torch.from_numpy(x), none, tg, sg)
    assert int(addr.n_occ[0]) == 0 and int(addr.overflow) == 0
    assert not tps._jblocks(addr, sg).any()
    rho, p, f = tps.pallas_rho_p_f(torch.from_numpy(x), torch.from_numpy(v),
                                   none, tp, tg, packed_rows=True)
    assert torch.isfinite(rho).all() and torch.isfinite(p).all()
    assert torch.equal(rho, torch.full_like(rho, tp.rest_density))
    assert not f.any()


def _small_scene():
    return port.calibrate(port.Scene(
        lo=(0.0, 0.0), hi=(200.0, 200.0),
        blocks=(port.Block(lo=(20.0, 20.0), hi=(80.0, 100.0)),),
    ))


GATES = {
    "method": (dict(method="naive"), "packed_rows requires method='pallas'"),
    "row_pair": (dict(sort_every=4, row_pair=True), "does not compose"),
    "xsub": (dict(xsub=2), "does not compose"),
    "repair": (dict(sort_every=4, repair_k=64), "minority slot repair"),
    "bf16": (dict(precision="bf16"), "requires fp32 features"),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_packed_flag_gates(gate):
    """The reference's ValueErrors on `packed_rows=True` (make_advance,
    sph_tpu/step.py:1279-1298), same messages."""
    kw, message = GATES[gate]
    kw = {"method": "pallas", "steps_per_dispatch": 8, **kw}
    scene = _small_scene()
    if "precision" in kw:
        scene = scene.replace(
            params=scene.params.replace(precision=kw.pop("precision")))
    with pytest.raises(ValueError, match=message):
        port.make_advance(scene, kw.pop("method"), packed_rows=True,
                          device="cpu", **kw)


def test_packed_wrappers_reject_malformed_arrays():
    feat = torch.zeros((3, 8, 256))
    n_occ = torch.zeros((1,), dtype=torch.int32)
    nbr = torch.zeros((3, 3), dtype=torch.int32)
    jb = torch.zeros((3,), dtype=torch.int32)
    gc = torch.zeros((3, 1, 2), dtype=torch.int32)
    p = port.SimParams()
    # two blocks and no halo is a valid packed row
    assert not packed_kernels.packed_density(feat, n_occ, nbr, jb, gc, p).any()
    with pytest.raises(TypeError):
        packed_kernels.packed_density(feat, n_occ, nbr, jb.long(), gc, p)
    with pytest.raises(ValueError):
        packed_kernels.packed_density(feat, n_occ, nbr, jb[:2], gc, p)
    with pytest.raises(ValueError):
        packed_kernels.packed_force(feat, torch.zeros((3, 2, 128)), n_occ,
                                    nbr, jb, gc, p)
