"""The CUDA kernels on a card against their plain PyTorch versions, and the
port's path through them.  Every test here is marked `gpu` and skips
without a card (decided inside the test).  The file imports neither JAX
nor `sph_tpu`, so it also runs where those are not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerances: rho rtol 1e-5 atol 1e-6 and f max-relative 3e-5, the
reference suite's own between its paths (summation orders differ); p
within the rho tolerance carried through the EOS slope.
"""

import numpy as np
import pytest
import torch

import sph_tpu_torch as port
from sph_tpu_torch import neighbors, slot_kernels
from sph_tpu_torch import pallas_step as ps

torch.set_num_threads(1)

RHO_RTOL, RHO_ATOL, FTOL = 1e-5, 1e-6, 3e-5


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _slots(dim, cap, kw, dev, n=3000, seed=51):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10.0, 170.0, (n, dim)).astype(np.float32)
    v = rng.uniform(-5.0, 5.0, (n, dim)).astype(np.float32)
    active = np.ones(n, bool)
    active[-n // 10:] = False
    params = port.SimParams(dim=dim, gravity=(0.0,) * dim, **kw)
    scene = port.Scene(params=params, lo=(0.0,) * dim, hi=(160.0,) * dim)
    grid = neighbors.GridSpec.for_scene(scene, cap=cap)
    sg = ps.slot_grid(grid)
    xt, vt, at = (torch.from_numpy(a).to(dev) for a in (x, v, active))
    addr = ps.build_addr(xt, at, grid, sg)
    feat = ps.scatter_slots(addr, ps._pack_rows6(xt, vt), sg)
    return params, sg, addr, feat


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dim,cap,kw",
    [(2, 16, {}), (2, 64, dict(pressure_floor=True)),
     (3, 16, dict(eos="tait", kernel_norm="proper")), (3, 8, {})],
    ids=["2d-cap16", "2d-cap64-floor", "3d-cap16-tait", "3d-cap8"],
)
def test_kernels_match_plain_versions(dim, cap, kw):
    params, sg, addr, feat = _slots(dim, cap, kw, _card())
    args = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params)
    before = dict(slot_kernels.LAUNCHES)
    rp = slot_kernels.slot_density(feat, *args)
    rp_p = slot_kernels.density_plain(feat, *args)
    f = slot_kernels.slot_force(feat, rp, *args)
    f_p = slot_kernels.force_plain(feat, rp, *args)
    torch.cuda.synchronize()
    assert slot_kernels.LAUNCHES["slot_density"] == before["slot_density"] + 1
    assert slot_kernels.LAUNCHES["slot_force"] == before["slot_force"] + 1

    assert torch.allclose(rp[:, 0], rp_p[:, 0], rtol=RHO_RTOL, atol=RHO_ATOL)
    rho = rp_p[:, 0].double()
    if params.eos == "ideal":
        slope = torch.full_like(rho, params.stiffness)
    else:
        b = params.sound_speed**2 * params.rest_density / params.tait_gamma
        slope = (b * params.tait_gamma / params.rest_density
                 * (rho / params.rest_density) ** (params.tait_gamma - 1))
    tol = 2.0 * slope * (RHO_ATOL + RHO_RTOL * rho.abs()) + 1e-6 * rp_p[:, 1].abs()
    assert bool(((rp[:, 1] - rp_p[:, 1]).abs() <= tol).all())
    scale = float(f_p.abs().max())
    assert scale > 0
    assert float((f - f_p).abs().max()) / scale < FTOL
    # run to run, the kernels give the same bits (fixed order, no atomics)
    assert torch.equal(slot_kernels.slot_density(feat, *args), rp)
    assert torch.equal(slot_kernels.slot_force(feat, rp, *args), f)


@pytest.mark.gpu
def test_run_on_card_goes_through_the_kernels():
    dev = _card()
    scene = port.preset("dam2d_10k")
    slot_kernels.reset_launches()
    state = port.run(scene, 10, method="pallas", device=dev)
    torch.cuda.synchronize()
    assert slot_kernels.LAUNCHES == {"slot_density": 10, "slot_force": 10}
    assert state.x.is_cuda and bool(torch.isfinite(state.x).all())
    host = port.run(scene, 10, method="pallas", device="cpu")
    xs = host.x.abs().max()
    assert float((state.x.cpu() - host.x).abs().max() / xs) < 1e-4
