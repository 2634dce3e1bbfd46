"""Port slot path (`sph_tpu_torch.pallas_step` + `slot_kernels`) vs the
reference `sph_tpu.pallas_step`, whose Pallas kernels run in interpret mode
on the CPU exactly as the reference suite runs them.

On the clouds of the reference's own equivalence tests (test_pallas_equiv
CASES: 2D and 3D, an inactive tail, one crowded cell, particles on cell
borders, particles outside the domain) plus cap-8 cell overflow, a
c_rows row-cap overflow, and production cap-16 grids:

  * every SlotAddr field is exactly equal (integer addressing);
  * scatter_slots is bitwise equal;
  * K1's and K2's plain versions agree with `_call_density`/`_call_force`
    per particle: rho rtol 1e-5 atol 1e-6, f max-relative 3e-5 — the
    reference suite's tolerances between its own paths
    (test_pallas_equiv.py:32, 55), since summation orders differ;
  * `pallas_rho_p_f` as a whole agrees at the same tolerances.

The CUDA kernels themselves are checked against the plain versions on a
card, by `tests/test_torch_gpu.py` and `chip_smoke.py`.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cloud

from sph_tpu import neighbors as jnb
from sph_tpu import pallas_step as jps
from sph_tpu.params import Scene as JScene
from sph_tpu.params import SimParams as JSimParams
from sph_tpu_torch import neighbors as tnb
from sph_tpu_torch import pallas_step as tps
from sph_tpu_torch.params import Scene, SimParams

torch.set_num_threads(1)

RHO_RTOL, RHO_ATOL, FTOL = 1e-5, 1e-6, 3e-5
ADDR_FIELDS = ("pos", "valid", "row_pos", "gcounts", "n_occ", "nbr_pos",
               "overflow", "row_code")


def _snap(n, d):  # particles exactly on cell borders (h = 16)
    return np.round(random_cloud(n, d, 0.0, 120.0, seed=33)[0] / 16.0) * 16.0


CLOUDS = {
    "uniform": lambda n, d: random_cloud(n, d, 0.0, 120.0, seed=31)[0],
    "one_cell": lambda n, d: random_cloud(n, d, 40.0, 55.0, seed=32)[0],
    "borders": _snap,
    "outside": lambda n, d: random_cloud(n, d, -30.0, 150.0, seed=34)[0],
    "crowded": lambda n, d: random_cloud(n, d, 40.0, 60.0, seed=36)[0],
}

# name: (dim, cloud, n, cap (None = GridSpec default), c_rows, params kw)
CASES = {
    **{f"{c}{d}d": (d, c, 200, 64, None, {})
       for c in ("uniform", "one_cell", "borders", "outside") for d in (2, 3)},
    "cap8_overflow2d": (2, "crowded", 128, 8, None, {}),
    "row_cap2d": (2, "uniform", 256, None, 2, {}),
    "cap16_tait3d": (3, "uniform", 300, None, None,
                     dict(eos="tait", integrator="leapfrog")),
    "cap16_floor2d": (2, "outside", 300, None, None,
                      dict(pressure_floor=True, kernel_norm="legacy3d")),
}


def _inputs(name):
    dim, cloud, n, cap, c_rows, kw = CASES[name]
    x = CLOUDS[cloud](n, dim)[:, :dim].astype(np.float32)
    v = np.random.default_rng(35).uniform(-5, 5, (n, dim)).astype(np.float32)
    active = np.ones(n, bool)
    active[int(0.9 * n):] = False
    kw = dict(dim=dim, gravity=(0.0,) * dim, **{"kernel_norm": "proper", **kw})
    box = dict(lo=(0.0,) * dim, hi=(120.0,) * dim)
    jp, tp = JSimParams(**kw), SimParams(**kw)
    jg = jnb.GridSpec.for_scene(JScene(params=jp, **box), cap=cap)
    tg = tnb.GridSpec.for_scene(Scene(params=tp, **box), cap=cap)
    return x, v, active, jp, tp, jg, tg, c_rows


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's slot arrays and results (Pallas interpret mode)."""
    x, v, active, jp, _, jg, _, c_rows = _inputs(name)
    xa, va, aa = jnp.asarray(x), jnp.asarray(v), jnp.asarray(active)
    sg = jps.slot_grid(jg, c_rows)
    addr = jps.build_addr(xa, aa, jg, sg)
    feat = jps.scatter_slots(addr, jps._pack_rows6(xa, va), sg)
    rp = jps._call_density(feat, addr, sg, jp)
    f_slot = jps._call_force(feat, rp, addr, sg, jp)
    rho, ok = jps._gather_rho(rp, addr, sg, jp)
    f = jps._gather_f(f_slot, addr, sg, x.shape[1], ok)
    whole = jps.pallas_rho_p_f(xa, va, aa, jp, jg, c_rows=c_rows)
    return dict(
        sg=sg,
        addr={k: np.asarray(getattr(addr, k)) for k in ADDR_FIELDS},
        feat=np.asarray(feat), rp=np.asarray(rp), rho=np.asarray(rho),
        ok=np.asarray(ok), f=np.asarray(f),
        whole=tuple(np.asarray(a) for a in whole),
    )


@functools.lru_cache(maxsize=None)
def _port(name):
    x, v, active, _, tp, _, tg, c_rows = _inputs(name)
    xt, vt, at = map(torch.from_numpy, (x, v, active))
    sg = tps.slot_grid(tg, c_rows)
    addr = tps.build_addr(xt, at, tg, sg)
    feat = tps.scatter_slots(addr, tps._pack_rows6(xt, vt), sg)
    return sg, addr, feat, tp


def _rel_f(a, b):
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)


def _p_close(p, p_ref, rho, params) -> bool:
    """p within the rho tolerance carried through the EOS slope dp/drho
    (x2 for the rounding of the EOS itself)."""
    rho = rho.astype(np.float64)
    if params.eos == "ideal":
        slope = np.full_like(rho, params.stiffness)
    else:
        b = params.sound_speed**2 * params.rest_density / params.tait_gamma
        r = rho / params.rest_density
        slope = b * params.tait_gamma / params.rest_density * r ** (params.tait_gamma - 1)
    tol = 2.0 * slope * (RHO_ATOL + RHO_RTOL * np.abs(rho)) + 1e-6 * np.abs(p_ref)
    return bool(np.all(np.abs(p - p_ref) <= tol))


@pytest.mark.parametrize("name", sorted(CASES))
def test_slot_addr_exactly_equal(name):
    ref = _reference(name)
    sg, addr, _, _ = _port(name)
    assert (sg.c_rows, sg.lanes, sg.n_groups) == (
        ref["sg"].c_rows, ref["sg"].lanes, ref["sg"].n_groups)
    for k in ADDR_FIELDS:
        a, b = getattr(addr, k).numpy(), ref["addr"][k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    if name.startswith(("cap8", "row_cap")):
        assert int(addr.overflow) > 0  # the static caps really dropped work
        x, _, active, _, _, jg, tg, _ = _inputs(name)
        ours = tps.slot_overflow(torch.from_numpy(x), torch.from_numpy(active),
                                 tg, sg)
        theirs = jps.slot_overflow(jnp.asarray(x), jnp.asarray(active), jg,
                                   ref["sg"])
        assert tuple(map(int, ours)) == tuple(map(int, theirs))


@pytest.mark.parametrize("name", sorted(CASES))
def test_scatter_slots_bitwise_equal(name):
    _, _, feat, _ = _port(name)
    assert np.array_equal(feat.numpy(), _reference(name)["feat"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_density_plain_matches_reference_kernel(name):
    ref = _reference(name)
    sg, addr, feat, tp = _port(name)
    rp = tps._call_density(feat, addr, sg, tp)
    rho, ok = tps._gather_rho(rp, addr, sg, tp)
    assert np.array_equal(ok.numpy(), ref["ok"])
    assert np.allclose(rho.numpy(), ref["rho"], rtol=RHO_RTOL, atol=RHO_ATOL)
    # the in-kernel EOS pressure, per particle
    lane = (addr.row_pos.long() * 2 + 1) * sg.lanes + addr.pos.long()
    okn = ok.numpy()
    p = rp.reshape(-1)[torch.where(ok, lane, 0)].numpy()[okn]
    p_ref = ref["rp"].reshape(-1)[np.where(okn, lane.numpy(), 0)][okn]
    assert _p_close(p, p_ref, ref["rho"][okn], tp)
    # rows past n_occ, the dummy row and the halo groups stay zero
    n_occ = int(addr.n_occ[0])
    assert not rp[0].any() and not rp[n_occ + 1:].any()
    assert not rp[:, :, : tps.LANE].any() and not rp[:, :, -tps.LANE:].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_force_plain_matches_reference_kernel(name):
    ref = _reference(name)
    sg, addr, feat, tp = _port(name)
    f_slot = tps._call_force(feat, torch.tensor(ref["rp"]), addr, sg, tp)
    ok = addr.ok()
    f = tps._gather_f(f_slot, addr, sg, tp.dim, ok).numpy()
    assert _rel_f(f, ref["f"]) < FTOL
    assert not f_slot[:, tp.dim:].any()  # components >= D stay zero


@pytest.mark.parametrize("name", sorted(CASES))
def test_pallas_rho_p_f_matches_reference(name):
    x, v, active, _, tp, _, tg, c_rows = _inputs(name)
    rho, p, f = tps.pallas_rho_p_f(
        *map(torch.from_numpy, (x, v, active)), tp, tg, c_rows=c_rows
    )
    rho_r, p_r, f_r = _reference(name)["whole"]
    assert np.allclose(rho.numpy(), rho_r, rtol=RHO_RTOL, atol=RHO_ATOL)
    assert _p_close(p.numpy(), p_r, rho_r, tp)
    assert _rel_f(f.numpy(), f_r) < FTOL
    assert np.all(np.isfinite(f.numpy()))
