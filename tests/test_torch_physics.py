"""Port physics (`sph_tpu_torch.physics`) vs `sph_tpu.physics` and the
frozen NumPy oracle (`oracle_numpy.py`), on the same numpy inputs.

Tolerances are those of the reference suite's own comparisons
(test_oracle.py, test_physics.py): reduction orders differ between XLA,
PyTorch and the oracle's loops, so density and EOS agree to ~1e-5
relative and forces (cancellation-heavy) to 1e-4 of their scale."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle_numpy as oracle
from helpers import pdict, random_cloud

from sph_tpu import kernels as jkern
from sph_tpu import physics as jphys
from sph_tpu.params import ForceField as JForceField
from sph_tpu.params import SimParams as JSimParams
from sph_tpu_torch import kernels as tkern
from sph_tpu_torch import physics as tphys
from sph_tpu_torch.params import ForceField, SimParams

torch.set_num_threads(1)

CONFIGS = [(2, "legacy3d", "ideal"), (2, "proper", "ideal"),
           (3, "proper", "tait")]


def _params(dim, kernel_norm="proper", eos="ideal", **kw):
    g = (0.0, -9.81) if dim == 2 else (0.0, -9.81, 0.0)
    kw = dict(dim=dim, kernel_norm=kernel_norm, eos=eos, gravity=g, **kw)
    return SimParams(**kw), JSimParams(**kw)


def _rel(a, b, floor=1e-6):
    return np.max(np.abs(a - b) / (np.maximum(np.abs(b), floor) + floor))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("dim,kernel_norm,eos", CONFIGS)
def test_density_naive_vs_reference_and_oracle(dim, kernel_norm, eos):
    pt, pj = _params(dim, kernel_norm, eos)
    x, _ = random_cloud(300, dim, 0.0, 100.0, seed=1)
    active = np.ones(300, bool)
    active[250:] = False
    rho = tphys.density_naive(_t(x), _t(active), pt).numpy()
    rho_j = np.asarray(jphys.density_naive(jnp.asarray(x), jnp.asarray(active), pj))
    rho_o = oracle.density(x, active, pdict(pj))
    assert _rel(rho[active], rho_o[active]) < 1e-5
    assert np.allclose(rho, rho_j, rtol=1e-5, atol=1e-6)
    assert np.all(rho[~active] == pt.rest_density)


@pytest.mark.parametrize("eos", ["ideal", "tait"])
@pytest.mark.parametrize("floor", [False, True])
def test_eos_vs_reference_and_oracle(eos, floor):
    pt, pj = _params(3, eos=eos, pressure_floor=floor)
    rho = np.random.default_rng(4).uniform(900.0, 1100.0, 500).astype(np.float32)
    pr = tphys.eos_pressure(_t(rho), pt).numpy()
    pr_j = np.asarray(jphys.eos_pressure(jnp.asarray(rho), pj))
    pr_o = oracle.eos(rho, pdict(pj))
    assert np.allclose(pr, pr_o, rtol=1e-5, atol=1e-3)
    assert np.allclose(pr, pr_j, rtol=1e-5, atol=1e-3)
    if floor:
        assert np.all(pr >= 0)


@pytest.mark.parametrize("dim", [2, 3])
def test_forces_naive_vs_reference_and_oracle(dim):
    pt, pj = _params(dim)
    x, v = random_cloud(256, dim, 0.0, 80.0, seed=2)
    active = np.ones(256, bool)
    active[240:] = False
    rho_o = oracle.density(x, active, pdict(pj))
    pr_o = oracle.eos(rho_o, pdict(pj))
    f = tphys.forces_naive(_t(x), _t(v), _t(rho_o), _t(pr_o), _t(active), pt).numpy()
    f_j = np.asarray(jphys.forces_naive(
        jnp.asarray(x), jnp.asarray(v), jnp.asarray(rho_o), jnp.asarray(pr_o),
        jnp.asarray(active), pj))
    f_o = oracle.forces(x, v, rho_o, pr_o, active, pdict(pj))
    scale = np.max(np.abs(f_o)) + 1e-6
    assert np.max(np.abs(f - f_o)) / scale < 1e-4
    assert np.max(np.abs(f - f_j)) / scale < 1e-5
    assert np.all(f[~active] == 0)


@pytest.mark.parametrize("dim", [2, 3])
def test_walls_and_clamp_vs_reference(dim):
    pt, pj = _params(dim)
    lo, hi = (0.0,) * dim, (200.0,) * dim
    x, v = random_cloud(400, dim, -20.0, 220.0, seed=5, vmax=30.0)
    f = tphys.wall_penalty_force(_t(x), _t(v), lo, hi, pt).numpy()
    f_j = np.asarray(jphys.wall_penalty_force(jnp.asarray(x), jnp.asarray(v), lo, hi, pj))
    f_o = oracle.wall_penalty(x, v, lo, hi, pdict(pj))
    assert np.allclose(f, f_o, rtol=1e-6, atol=1e-3)
    assert np.allclose(f, f_j, rtol=1e-6, atol=1e-3)
    xc, vc = tphys.clamp_boundary(_t(x), _t(v), lo, hi, pt)
    xc_j, vc_j = jphys.clamp_boundary(jnp.asarray(x), jnp.asarray(v), lo, hi, pj)
    assert np.array_equal(xc.numpy(), np.asarray(xc_j))
    assert np.array_equal(vc.numpy(), np.asarray(vc_j))


@pytest.mark.parametrize("step", [0, 150, 400])
def test_gravity_and_force_fields_vs_reference(step):
    pt, pj = _params(2)
    fields = [dict(pos=(100.0, 100.0), strength=5e4, radius=80.0,
                   start_step=100, stop_step=300),
              dict(pos=(40.0, 160.0), strength=-2e4, radius=50.0)]
    x, _ = random_cloud(300, 2, 0.0, 200.0, seed=6)
    rho = np.random.default_rng(7).uniform(900.0, 1100.0, 300).astype(np.float32)
    f = tphys.force_field_force(
        _t(x), torch.tensor(step, dtype=torch.int32),
        [ForceField(**ff) for ff in fields]).numpy()
    f_j = np.asarray(jphys.force_field_force(
        jnp.asarray(x), jnp.int32(step), [JForceField(**ff) for ff in fields]))
    assert np.allclose(f, f_j, rtol=1e-5, atol=1e-2)
    g = tphys.gravity_force(_t(rho), pt).numpy()
    assert np.array_equal(g, np.asarray(jphys.gravity_force(jnp.asarray(rho), pj)))


@pytest.mark.parametrize("dim,norm", [(2, "proper"), (3, "proper"),
                                      (2, "legacy3d")])
def test_kernel_forms_vs_reference(dim, norm):
    """spiky_grad_scale, visc_lap and spiky_w (the forms
    tests/test_kernels.py checks the normalizations with) on r across and
    beyond the support, the self-pair r = 0 included."""
    h = 1.3
    _, cs, cv = tkern.kernel_constants(dim, h, norm)
    r = np.concatenate([[0.0, 1e-13], np.linspace(0.0, 3 * h, 301)]
                       ).astype(np.float32)
    pairs = [
        (tkern.spiky_grad_scale(_t(r), h, cs), jkern.spiky_grad_scale(r, h, cs)),
        (tkern.visc_lap(_t(r), h, cv), jkern.visc_lap(r, h, cv)),
        (tkern.spiky_w(_t(r), h, dim, norm), jkern.spiky_w(r, h, dim, norm)),
    ]
    for ours, ref in pairs:
        assert np.allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=0)
    assert float(pairs[0][0][0]) == 0.0 and float(pairs[0][0][-1]) == 0.0
