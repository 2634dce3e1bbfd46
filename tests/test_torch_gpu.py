"""The CUDA kernels (K1-K5, P1) on a card against their plain PyTorch
versions, the staged K1/K2 and the warp K3/K4 bitwise against their simple
yardsticks, and the port's paths through them.  Every test here is marked `gpu` and skips
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
from sph_tpu_torch import neighbors, packed_kernels, repair, slot_kernels
from sph_tpu_torch import slot_pass, stage_kernels
from sph_tpu_torch import step as port_step
from sph_tpu_torch import pallas_step as ps
from sph_tpu_torch import probe_vpu_bf16 as probe
from torch_repair_carries import (PLACED, clone, cloud, cloud_side, lattice,
                                  placed, slab)

torch.set_num_threads(1)

RHO_RTOL, RHO_ATOL, FTOL = 1e-5, 1e-6, 3e-5


def _slot_launches(n: int) -> dict:
    """LAUNCHES after a path that ran the fp32 K1/K2 n times each: no bf16
    kernel and no yardstick."""
    out = dict.fromkeys(slot_kernels.LAUNCHES, 0)
    out.update(slot_density=n, slot_force=n)
    return out


def _packed_launches(n: int) -> dict:
    """packed LAUNCHES after a path that ran K3/K4 n times each: no
    yardstick and no variant."""
    out = dict.fromkeys(packed_kernels.LAUNCHES, 0)
    out.update(packed_density=n, packed_force=n)
    return out


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _slots(dim, cap, kw, dev, n=3000, seed=51, xsub=1):
    """(params, sg, addr, feat) of a random cloud; `precision="bf16"` in
    `kw` makes bf16 cell-relative features."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10.0, 170.0, (n, dim)).astype(np.float32)
    v = rng.uniform(-5.0, 5.0, (n, dim)).astype(np.float32)
    active = np.ones(n, bool)
    active[-n // 10:] = False
    params = port.SimParams(dim=dim, gravity=(0.0,) * dim, **kw)
    scene = port.Scene(params=params, lo=(0.0,) * dim, hi=(160.0,) * dim)
    grid = neighbors.GridSpec.for_scene(scene, cap=cap, xsub=xsub)
    sg = ps.slot_grid(grid)
    xt, vt, at = (torch.from_numpy(a).to(dev) for a in (x, v, active))
    bf16 = params.precision == "bf16"
    addr = ps.build_addr(xt, at, grid, sg)
    rows = ps._rel_rows(xt, vt, addr) if bf16 else ps._pack_rows6(xt, vt)
    feat = ps.scatter_slots(addr, rows, sg)
    return params, sg, addr, feat


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dim,cap,xsub,kw",
    [(2, 16, 1, dict(precision="bf16")),
     (3, 16, 1, dict(precision="bf16", eos="tait", kernel_norm="proper")),
     (3, 16, 2, {}), (2, 64, 4, {}), (3, 16, 2, dict(precision="bf16"))],
    ids=["2d-bf16", "3d-bf16-tait", "3d-xsub2", "2d-cap64-xsub4",
         "3d-bf16-xsub2"],
)
def test_bf16_and_xsub_kernels_match_plain_versions(dim, cap, xsub, kw):
    """The bf16 and xsub branches of K1/K2 against their plain versions
    at the fp32 tolerances (the pair distances are rebuilt with the same
    roundings on both sides), bf16 launches counted apart."""
    params, sg, addr, feat = _slots(dim, cap, kw, _card(), xsub=xsub)
    bf16 = feat.dtype == torch.bfloat16
    args = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params,
            sg.xsub, sg.cell)
    before = dict(slot_kernels.LAUNCHES)
    rp = slot_kernels.slot_density(feat, *args)
    f = slot_kernels.slot_force(feat, rp, *args)
    rp_p = slot_kernels.density_plain(feat, *args)
    f_p = slot_kernels.force_plain(feat, rp, *args)
    torch.cuda.synchronize()
    suffix = "_bf16" if bf16 else ""
    for name in ("slot_density", "slot_force"):
        assert slot_kernels.LAUNCHES[name + suffix] == before[name + suffix] + 1
    ok = addr.ok()
    rho, _ = ps._gather_rho(rp, addr, sg, params)
    rho_p, _ = ps._gather_rho(rp_p, addr, sg, params)
    assert torch.allclose(rho[ok], rho_p[ok], rtol=RHO_RTOL, atol=RHO_ATOL)
    scale = float(f_p.abs().max())
    assert scale > 0
    assert float((f - f_p).abs().max()) / scale < FTOL


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uniform", "probe"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_probe_kernels_bitwise_plain_version(dtype, kind):
    """P1's kernels, bitwise the plain chain: finite on U[0,1), all inf on
    the probe's own inputs."""
    dev = _card()
    if kind == "probe":
        x, y = probe.probe_inputs(dtype, dev)
    else:
        gen = torch.Generator(device=dev).manual_seed(61)
        x, y = (torch.rand((probe.SUB, probe.LANE), generator=gen,
                           device=dev).to(dtype) for _ in range(2))
    before = dict(probe.LAUNCHES)
    got = probe.probe(x, y)
    want = probe.chain_plain(x, y)
    torch.cuda.synchronize()
    name = "probe_bf16" if dtype == torch.bfloat16 else "probe_f32"
    assert probe.LAUNCHES[name] == before[name] + 1
    assert torch.equal(got, want)
    assert bool(torch.isinf(got).all()) if kind == "probe" else bool(
        torch.isfinite(got).all())


@pytest.mark.gpu
def test_probe_bench_counts_the_launches_that_run():
    """`bench` runs `iters` launches four times (warm-up, two graph
    replays, direct); the capture records launches and runs none."""
    dev = _card()
    probe.reset_launches()
    probe.bench(torch.float32, 3, dev)
    assert probe.LAUNCHES == {"probe_f32": 12, "probe_bf16": 0}


@pytest.mark.gpu
def test_bf16_run_on_card_goes_through_the_bf16_kernels():
    dev = _card()
    scene = port.preset("dam2d_10k")
    scene = scene.replace(params=scene.params.replace(precision="bf16"))
    slot_kernels.reset_launches()
    state = port.run(scene, 8, method="pallas", sort_every=4,
                     slot_resident=True, steps_per_dispatch=8, device=dev)
    torch.cuda.synchronize()
    assert slot_kernels.LAUNCHES["slot_density"] == 0
    assert slot_kernels.LAUNCHES["slot_density_bf16"] >= 8
    assert bool(torch.isfinite(state.x).all())


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
    assert slot_kernels.LAUNCHES == _slot_launches(10)
    assert state.x.is_cuda and bool(torch.isfinite(state.x).all())
    host = port.run(scene, 10, method="pallas", device="cpu")
    xs = host.x.abs().max()
    assert float((state.x.cpu() - host.x).abs().max() / xs) < 1e-4


def _packed_slots(dim, row_lanes, kw, dev, seed=53, n=None):
    """A cloud in a narrow tall box: rows hold several hundred particles
    (`n` at its default), so neighbor rows span more than one 128-lane
    block."""
    rng = np.random.default_rng(seed)
    n = n or (1500 if dim == 2 else 6000)
    hi = (48.0, 400.0) if dim == 2 else (48.0, 64.0, 400.0)
    x = rng.uniform(-5.0, 1.0, (n, dim)).astype(np.float32)
    x = (x + 5.0) / 6.0 * (np.asarray(hi, np.float32) + 10.0) - 5.0
    v = rng.uniform(-5.0, 5.0, (n, dim)).astype(np.float32)
    active = np.ones(n, bool)
    active[-n // 10:] = False
    params = port.SimParams(dim=dim, gravity=(0.0,) * dim, **kw)
    scene = port.Scene(params=params, lo=(0.0,) * dim, hi=hi)
    grid = neighbors.GridSpec.for_scene(scene, cap=64)
    sg = ps.packed_grid(grid, row_lanes)
    xt, vt, at = (torch.from_numpy(a).to(dev) for a in (x, v, active))
    addr = ps.build_addr(xt, at, grid, sg)
    feat = ps.scatter_slots(addr, ps._pack_rows6(xt, vt), sg)
    return params, sg, addr, feat


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dim,row_lanes,kw",
    [(2, 512, {}), (2, 128, dict(pressure_floor=True)),
     (3, 640, dict(eos="tait", kernel_norm="proper")), (3, 256, {})],
    ids=["2d-512", "2d-128-overflow-floor", "3d-640-tait", "3d-256-overflow"],
)
def test_packed_kernels_match_plain_versions(dim, row_lanes, kw):
    """Raw rp / f of K3 / K4 against the plain versions, zeros included."""
    params, sg, addr, feat = _packed_slots(dim, row_lanes, kw, _card())
    jb = ps._jblocks(addr, sg)
    assert int(jb.max()) >= 2 or row_lanes == 128
    assert (int(addr.overflow) > 0) == (row_lanes in (128, 256))
    args = (addr.n_occ, addr.nbr_pos, jb, addr.gcounts, params)
    before = dict(packed_kernels.LAUNCHES)
    rp = packed_kernels.packed_density(feat, *args)
    rp_p = packed_kernels.packed_density_plain(feat, *args)
    f = packed_kernels.packed_force(feat, rp, *args)
    f_p = packed_kernels.packed_force_plain(feat, rp, *args)
    torch.cuda.synchronize()
    assert packed_kernels.LAUNCHES["packed_density"] == before["packed_density"] + 1
    assert packed_kernels.LAUNCHES["packed_force"] == before["packed_force"] + 1

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
    # exact zeros wherever the plain version has none to compute
    empty = feat[:, 0] >= 1e17
    assert not rp[:, 0][empty].any() and not rp[:, 1][empty].any()
    assert not f[:, 0][empty].any() and not f[:, dim:].any()
    # run to run, the kernels give the same bits (fixed order, no atomics)
    assert torch.equal(packed_kernels.packed_density(feat, *args), rp)
    assert torch.equal(packed_kernels.packed_force(feat, rp, *args), f)


@pytest.mark.gpu
def test_packed_kernels_on_an_empty_scene():
    """n_occ == 0: zeros and nothing else."""
    dev = _card()
    params, sg, addr, feat = _packed_slots(2, 256, {}, dev)
    none = torch.zeros(1500, dtype=torch.bool, device=dev)
    scene = port.Scene(params=params, lo=(0.0, 0.0), hi=(48.0, 400.0))
    grid = neighbors.GridSpec.for_scene(scene, cap=64)
    addr = ps.build_addr(torch.zeros((1500, 2), device=dev), none, grid, sg)
    feat = ps.scatter_slots(addr, torch.zeros((1500, 6), device=dev), sg)
    jb = ps._jblocks(addr, sg)
    rp = packed_kernels.packed_density(feat, addr.n_occ, addr.nbr_pos, jb,
                                       addr.gcounts, params)
    f = packed_kernels.packed_force(feat, rp, addr.n_occ, addr.nbr_pos, jb,
                                    addr.gcounts, params)
    torch.cuda.synchronize()
    assert int(addr.n_occ[0]) == 0 and not rp.any() and not f.any()


@pytest.mark.gpu
def test_packed_run_on_card_goes_through_the_packed_kernels():
    dev = _card()
    scene = port.preset("dam2d_10k")
    slot_kernels.reset_launches()
    packed_kernels.reset_launches()
    state = port.run(scene, 8, method="pallas", packed_rows=True, sort_every=4,
                     steps_per_dispatch=8, device=dev)
    torch.cuda.synchronize()
    # a leapfrog scene's prime at step 0 runs on the slot layout, as in the
    # reference; this Euler scene has none
    primes = int(scene.params.integrator == "leapfrog")
    assert slot_kernels.LAUNCHES == _slot_launches(primes)
    assert packed_kernels.LAUNCHES == _packed_launches(8)
    assert state.x.is_cuda and bool(torch.isfinite(state.x).all())
    host = port.run(scene, 8, method="pallas", packed_rows=True, sort_every=4,
                    steps_per_dispatch=8, device="cpu")
    xs = host.x.abs().max()
    assert float((state.x.cpu() - host.x).abs().max() / xs) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True], ids=["slot", "packed"])
@pytest.mark.parametrize("dim", [2, 3])
def test_stage_transpose_matches_plain_version(dim, packed):
    """K5 against its plain version, and `scatter_slots(staged=True)`
    against the direct scatter: bitwise, empty slots and dropped particles
    included."""
    dev = _card()
    if packed:
        _, sg, addr, _ = _packed_slots(dim, 256, {}, dev)
    else:
        _, sg, addr, _ = _slots(dim, 16, {}, dev)
    n = addr.pos.shape[0]
    gen = torch.Generator(device=dev).manual_seed(57)
    rows = torch.rand((n, 7), generator=gen, device=dev)
    stag = torch.rand((sg.c_rows * sg.lanes, 8), generator=gen, device=dev)
    before = stage_kernels.LAUNCHES["stage_transpose"]
    out = stage_kernels.stage_transpose(stag, sg.c_rows, sg.lanes)
    staged = ps.scatter_slots(addr, rows, sg, staged=True)
    torch.cuda.synchronize()
    assert stage_kernels.LAUNCHES["stage_transpose"] == before + 2
    assert torch.equal(out, stage_kernels.stage_transpose_plain(
        stag, sg.c_rows, sg.lanes))
    assert torch.equal(staged, ps.scatter_slots(addr, rows, sg))
    assert not bool(addr.ok().all())


@pytest.mark.gpu
def test_production_default_on_card_goes_through_the_kernels():
    """`run(..., sort_every=4, slot_resident=True)`: K1/K2 once a step on
    the slot layout plus 4 a healed block (its exact re-run), the block's
    passes once a step (slot_post) and once a block (slot_pre, whose
    in-place steps Euler does not need), and the same trajectory as on the
    host within the reference's trajectory bounds."""
    dev = _card()
    scene = port.preset("dam2d_10k")
    slot_kernels.reset_launches()
    packed_kernels.reset_launches()
    slot_pass.reset_launches()
    audited = port.make_audited_advance(scene, "pallas", 16, sort_every=4,
                                        slot_resident=True, device=dev)
    state = audited(port.init(scene, device=dev))
    torch.cuda.synchronize()
    want = 16 + 4 * audited.healed
    assert audited.mode != "perstep"   # no dispatch ran demoted
    assert slot_kernels.LAUNCHES == _slot_launches(want)
    assert packed_kernels.LAUNCHES == _packed_launches(0)
    assert slot_pass.LAUNCHES == {"slot_pre": 4, "slot_post": 16}
    assert state.x.is_cuda and bool(torch.isfinite(state.x).all())
    host = port.make_audited_advance(scene, "pallas", 16, sort_every=4,
                                     slot_resident=True, device="cpu")
    host_state = host(port.init(scene, device="cpu"))
    assert (host.healed, host.rebuilds) == (audited.healed, audited.rebuilds)
    xs = host_state.x.abs().max()
    assert float((state.x.cpu() - host_state.x).abs().max() / xs) < 1e-4


def _holes(feat, addr, frac: float, seed: int):
    """Empty a random `frac` of the live slots of rows 1..n_occ as the
    resident path's minority repair leaves them (x at 1e18, v 0), so cells
    have holes below their last particle.  Returns the number emptied."""
    n = int(addr.n_occ[0])
    x0 = feat[1 : n + 1, 0].float()
    rows, lanes = torch.nonzero(x0 < 1e17, as_tuple=True)
    rng = np.random.default_rng(seed)
    pick = torch.from_numpy(rng.random(rows.shape[0]) < frac).to(feat.device)
    rows, lanes = rows[pick] + 1, lanes[pick]
    for c in range(3):
        feat[rows, c, lanes] = 1e18
        feat[rows, 3 + c, lanes] = 0.0
    return int(pick.sum())


def _bitwise(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _staged_vs_simple(params, sg, feat, addr):
    """K1/K2 staged and simple on the same inputs: every output element
    bitwise (zeros of empty lanes, empty groups and rows past n_occ
    included); launches counted under their own names."""
    args = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params, sg.xsub,
            sg.cell)
    sfx = "_bf16" if feat.dtype == torch.bfloat16 else ""
    before = dict(slot_kernels.LAUNCHES)
    rp = slot_kernels.slot_density(feat, *args)
    rp_s = slot_kernels.slot_density_simple(feat, *args)
    f = slot_kernels.slot_force(feat, rp, *args)
    f_s = slot_kernels.slot_force_simple(feat, rp, *args)
    torch.cuda.synchronize()
    for name in ("slot_density", "slot_force", "slot_density_simple",
                 "slot_force_simple"):
        assert slot_kernels.LAUNCHES[name + sfx] == before[name + sfx] + 1
    assert _bitwise(rp, rp_s)
    assert _bitwise(f, f_s)
    assert bool(torch.isfinite(rp).all() and torch.isfinite(f).all())
    return rp, f


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("xsub", [1, 2])
@pytest.mark.parametrize("cap", [8, 16, 64])
@pytest.mark.parametrize("dim", [2, 3])
def test_staged_kernels_bitwise_simple_with_holes(dim, cap, xsub, bf16):
    """The staged K1/K2 give the simple kernels' bits on a cloud whose
    cells have holes (10% of the live slots emptied as repair does); the
    plain versions agree at the fp32 tolerances."""
    dev = _card()
    kw = dict(precision="bf16") if bf16 else {}
    params, sg, addr, feat = _slots(dim, cap, kw, dev, xsub=xsub,
                                    seed=70 + dim + cap + xsub)
    assert _holes(feat, addr, 0.1, seed=cap + xsub) > 0
    rp, f = _staged_vs_simple(params, sg, feat, addr)
    args = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params, sg.xsub,
            sg.cell)
    rp_p = slot_kernels.density_plain(feat, *args)
    f_p = slot_kernels.force_plain(feat, rp, *args)
    assert torch.allclose(rp[:, 0], rp_p[:, 0], rtol=RHO_RTOL, atol=RHO_ATOL)
    scale = float(f_p.abs().max())
    assert scale > 0 and float((f - f_p).abs().max()) / scale < FTOL
    empty = feat[:, 0].float() >= 1e17
    assert not rp[:, 0][empty].any() and not f[:, 0][empty].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [2, 3])
def test_cap32_kernels_bitwise_simple_and_plain(dim):
    """The staged K1/K2 on a cap-32 lattice (`bench_sweep`'s widest: a
    staged row's window is 128 + 2·32 slots) give the simple kernels' bits,
    agree with their plain versions at the fp32 tolerances, and count one
    launch each."""
    dev = _card()
    params, sg, addr, feat = _slots(dim, 32, {}, dev,
                                    n=2500 if dim == 2 else 20000,
                                    seed=90 + dim)
    assert sg.cap == 32 and int(addr.overflow) == 0
    # cells past cap 16, which only the cap-32 lattice holds
    occ = (feat[:, 0].reshape(feat.shape[0], -1, 32) < 1e17).sum(-1)
    assert int((occ > 16).sum()) > 0
    rp, f = _staged_vs_simple(params, sg, feat, addr)
    args = (addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap, params)
    rp_p = slot_kernels.density_plain(feat, *args)
    f_p = slot_kernels.force_plain(feat, rp, *args)
    assert torch.allclose(rp[:, 0], rp_p[:, 0], rtol=RHO_RTOL, atol=RHO_ATOL)
    scale = float(f_p.abs().max())
    assert scale > 0 and float((f - f_p).abs().max()) / scale < FTOL


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("dim", [2, 3])
def test_staged_kernels_bitwise_simple_at_the_edges(dim, bf16):
    """A cell filled to its cap (a dense clump), groups with no particle,
    and rows past n_occ: the staged K1/K2 bitwise the simple ones."""
    dev = _card()
    rng = np.random.default_rng(80 + dim)
    n_sparse, n_clump = 600, 400
    x = np.concatenate([
        rng.uniform(20.0, 140.0, (n_sparse, dim)),
        rng.uniform(80.0, 80.0 + 4.0, (n_clump, dim)),
    ]).astype(np.float32)
    x[:n_sparse, 0] = rng.uniform(20.0, 60.0, n_sparse)  # rows past n_occ
    v = rng.uniform(-5.0, 5.0, x.shape).astype(np.float32)
    kw = dict(precision="bf16") if bf16 else {}
    params = port.SimParams(dim=dim, gravity=(0.0,) * dim, **kw)
    scene = port.Scene(params=params, lo=(0.0,) * dim, hi=(160.0,) * dim)
    grid = neighbors.GridSpec.for_scene(scene, cap=16)
    sg = ps.slot_grid(grid)
    xt, vt = (torch.from_numpy(a).to(dev) for a in (x, v))
    addr = ps.build_addr(xt, torch.ones(x.shape[0], dtype=torch.bool,
                                        device=dev), grid, sg)
    rows = ps._rel_rows(xt, vt, addr) if bf16 else ps._pack_rows6(xt, vt)
    feat = ps.scatter_slots(addr, rows, sg)
    n_occ = int(addr.n_occ[0])
    inner = addr.gcounts[1 : n_occ + 1, 0, 1:-1]
    assert int(addr.overflow) > 0                      # a cell at its cap
    assert bool((inner == 0).any())                    # empty groups
    assert n_occ < sg.c_rows - 1                       # rows past n_occ
    assert _holes(feat, addr, 0.1, seed=dim) > 0
    _staged_vs_simple(params, sg, feat, addr)


def _warp_vs_simple(params, feat, args):
    """The warp K3/K4 and their simple yardsticks on the same inputs, and
    the warp kernels at every launch choice: every output element bitwise;
    launches counted under their own names."""
    before = dict(packed_kernels.LAUNCHES)
    rp = packed_kernels.packed_density(feat, *args)
    rp_s = packed_kernels.packed_density_simple(feat, *args)
    f = packed_kernels.packed_force(feat, rp, *args)
    f_s = packed_kernels.packed_force_simple(feat, rp, *args)
    torch.cuda.synchronize()
    for name in ("packed_density", "packed_force", "packed_density_simple",
                 "packed_force_simple"):
        assert packed_kernels.LAUNCHES[name] == before[name] + 1
    assert _bitwise(rp, rp_s)
    assert _bitwise(f, f_s)
    for warps in (1, 4, 8):
        for tile in (32, 64, 128):
            for prefetch in (False, True):
                for band in (False, True):
                    assert _bitwise(rp, packed_kernels.packed_density_variant(
                        feat, *args, warps, tile, prefetch, band))
                    assert _bitwise(f, packed_kernels.packed_force_variant(
                        feat, rp, *args, warps, tile, prefetch, band))
    assert bool(torch.isfinite(rp).all() and torch.isfinite(f).all())
    return rp, f


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dim,row_lanes,n",
    [(2, 128, None), (2, 256, None), (2, 384, None), (2, 512, None),
     (2, 640, 300), (3, 128, None), (3, 256, None), (3, 384, None),
     (3, 512, None), (3, 640, None), (3, 384, 1500)],
)
def test_warp_packed_kernels_bitwise_simple(dim, row_lanes, n):
    """The warp K3/K4 give the first design's bits at every row width,
    rows over 128 particles (dense clouds), rows of a few dozen (sparse),
    rows past n_occ and the dummy row 0; the plain versions agree at the
    fp32 tolerances."""
    dev = _card()
    params, sg, addr, feat = _packed_slots(dim, row_lanes, {}, dev,
                                           seed=60 + dim + row_lanes, n=n)
    jb = ps._jblocks(addr, sg)
    assert int(addr.n_occ[0]) < sg.c_rows - 1 and int(jb[0]) == 0
    assert int(jb.max()) >= 2 or row_lanes == 128 or n is not None
    args = (addr.n_occ, addr.nbr_pos, jb, addr.gcounts, params)
    rp, f = _warp_vs_simple(params, feat, args)
    rp_p = packed_kernels.packed_density_plain(feat, *args)
    f_p = packed_kernels.packed_force_plain(feat, rp, *args)
    assert torch.allclose(rp[:, 0], rp_p[:, 0], rtol=RHO_RTOL, atol=RHO_ATOL)
    scale = float(f_p.abs().max())
    assert scale > 0 and float((f - f_p).abs().max()) / scale < FTOL


@pytest.mark.gpu
def test_warp_packed_kernels_bitwise_simple_on_an_empty_scene():
    """n_occ == 0: both designs write zeros and nothing else."""
    dev = _card()
    params, sg, _, _ = _packed_slots(3, 256, {}, dev)
    none = torch.zeros(600, dtype=torch.bool, device=dev)
    scene = port.Scene(params=params, lo=(0.0,) * 3, hi=(48.0, 64.0, 400.0))
    grid = neighbors.GridSpec.for_scene(scene, cap=64)
    addr = ps.build_addr(torch.zeros((600, 3), device=dev), none, grid, sg)
    feat = ps.scatter_slots(addr, torch.zeros((600, 6), device=dev), sg)
    args = (addr.n_occ, addr.nbr_pos, ps._jblocks(addr, sg), addr.gcounts,
            params)
    rp, f = _warp_vs_simple(params, feat, args)
    assert int(addr.n_occ[0]) == 0 and not rp.any() and not f.any()


def _pre_inputs(dim, bf16, dev, seed=57):
    """A block's top (xs, vs, acc, movb) on a random cloud's slot
    addressing, the centers of its bf16 frame, and two blocks of storage
    holding the same garbage, so that an element a pass does not write
    shows as a difference between kernel and plain version only if one
    of them wrote it."""
    params, sg, addr, feat = _slots(dim, 16, {}, dev, seed=seed)
    rng = np.random.default_rng(seed)
    shape = (sg.c_rows, dim, sg.lanes)
    movb = feat[:, 6:7, :] > 0
    acc = torch.from_numpy(rng.normal(0.0, 3e3, shape).astype(np.float32))
    acc = torch.where(movb, acc.to(dev), 0.0)
    xs, vs = feat[:, 0:dim, :], feat[:, 3:3 + dim, :]
    centers = torch.from_numpy(rng.uniform(-5.0, 5.0, shape).astype(
        np.float32)).to(dev) + xs.clamp(max=200.0) if bf16 else None
    blocks = [slot_pass.SlotBlock(sg.c_rows, sg.lanes, dim, bf16, dev)
              for _ in range(2)]
    junk = torch.from_numpy(rng.normal(0.0, 9.0, (sg.c_rows, 8, sg.lanes))
                            .astype(np.float32)).to(dev)
    for blk in blocks:
        blk.feat.copy_(junk)
        blk.acc.copy_(junk[:, :dim])
        if bf16:
            blk.feat16.copy_(junk.to(torch.bfloat16))
        blk.count.fill_(7)
        blk.risky.fill_(9)
    return params, addr, (xs, vs, acc, movb), centers, blocks


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("mode", ["full_x0", "full", "occupied"])
@pytest.mark.parametrize("leap", [True, False], ids=["leapfrog", "euler"])
@pytest.mark.parametrize("dim", [2, 3])
def test_first_slot_pre_bitwise_plain_version(dim, leap, mode, bf16):
    """A block's first slot_pre, over every slot (with and without the
    copy of the top's x into x0) and over the occupied groups only (the
    persistent storage's), against its plain version on the same arrays:
    every element of both storages, x0, acc and the zeroed counts bitwise,
    one launch counted; the occupied-only pass leaves every element
    outside the occupied groups as it was."""
    dev = _card()
    params, addr, top, centers, blocks = _pre_inputs(dim, bf16, dev)
    full = mode != "occupied"
    x0s = [torch.full_like(top[2], -3.0) if mode == "full_x0" else None
           for _ in blocks]
    before = dict(slot_pass.LAUNCHES)
    untouched = blocks[0].feat.clone()
    tiles = slot_pass.occupied_tiles(addr.gcounts, addr.n_occ)
    kernel = (lambda *a, **k: slot_pass.slot_pre(*a, **k, tiles=tiles))
    for blk, x0, pre in zip(blocks, x0s, (kernel, slot_pass.slot_pre_plain)):
        pre(blk, *top, addr.gcounts, addr.n_occ, 1e-3, leap, leap, True,
            centers, full=full, x0=x0)
    torch.cuda.synchronize()
    assert slot_pass.LAUNCHES["slot_pre"] == before["slot_pre"] + 1
    a, b = blocks
    assert _bitwise(a.feat, b.feat) and _bitwise(a.acc, b.acc)
    if bf16:
        assert torch.equal(a.feat16.view(torch.int16),
                           b.feat16.view(torch.int16))
    assert int(a.count) == int(b.count) == 0 == int(a.risky) == int(b.risky)
    if mode == "full_x0":
        assert _bitwise(x0s[0], x0s[1]) and _bitwise(x0s[0], top[0])
    if not full:
        visit = slot_pass._visit(addr.gcounts, addr.n_occ, a.feat.shape[2])
        keep = ~visit.expand_as(a.feat)
        assert torch.equal(a.feat[keep].view(torch.int32),
                           untouched[keep].view(torch.int32))
        assert bool(visit.any()) and bool(keep.any())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["3d-calm", "2d-dart-repair"])
def test_persistent_storage_on_card_bitwise_fresh(case, monkeypatch):
    """The auto-rebuild advance on the card with the storage that
    outlives the block and with fresh storage every block: the state and
    the counters bitwise, and occupied-only first passes in the first."""
    dev = _card()
    if case == "3d-calm":
        p = port.SimParams(dim=3, gravity=(0.0, -9.81, 0.0),
                           kernel_norm="proper", eos="tait",
                           integrator="leapfrog", boundary_mode="penalty",
                           dt=4e-4)
        scene = port.calibrate(port.Scene(
            params=p, lo=(0.0,) * 3, hi=(300.0,) * 3,
            blocks=(port.Block(lo=(20.0,) * 3, hi=(110.0, 140.0, 110.0)),),
            seed=74))
        kw = {}
    else:
        p = port.SimParams()
        lo = (p.wall_eps + 4,) * 2
        scene = port.calibrate(port.Scene(
            params=p, lo=(0.0, 0.0), hi=(400.0, 400.0),
            blocks=(port.Block(lo=lo, hi=(lo[0] + 60, lo[1] + 100)),
                    port.Block(lo=(250.0, 250.0), hi=(262.0, 262.0),
                               velocity=(420.0, 0.0))), seed=97))
        kw = dict(repair_k=256)
    outs = []
    for fresh in (False, True):
        monkeypatch.setattr(slot_pass, "FRESH_STORAGE", fresh)
        slot_pass.reset_launches()
        st = port.init(scene, device=dev)
        if p.integrator == "leapfrog":
            st = port.prime(scene, st, "pallas", device=dev)
        res = port.make_advance(scene, "pallas", steps_per_dispatch=32,
                                sort_every=4, slot_resident=True,
                                auto_rebuild=True, device=dev, **kw)(st)
        torch.cuda.synchronize()
        outs.append((res, dict(slot_pass.BLOCKS)))
    (a, blocks), (b, _) = outs
    assert [int(t) for t in a[1:]] == [int(t) for t in b[1:]]
    for f in ("x", "v", "acc", "rho", "p"):
        assert _bitwise(getattr(a[0], f), getattr(b[0], f)), f
    assert blocks["occupied"] > 0


REPAIR_PLAN_KEYS = ("can", "n_risky", "pids", "vm", "x_m", "old_row",
                    "old_pos", "new_row", "new_pos")
REPAIR_CARRIES = sorted(PLACED) + ["cloud", "cloud_over_k", "cloud_aliased"]
# (slab, carry) of the slab cases: each hand-placed carry between interior
# faces, the veto, and clouds between interior faces and between walls
REPAIR_SLAB_CARRIES = ([f"interior-{n}" for n in sorted(PLACED)]
                       + ["veto-several_into_one", "interior-cloud",
                          "walls-cloud"])


def _repair_carry(dim, cap, name, dev, slab_name=None):
    """(tools' args, tools' keywords, carry, x0, act, movable, other
    storage, can or None) of a carry of `torch_repair_carries`, on the slab
    `slab_name`'s lattice when given."""
    gather = port_step._SlotPhysics.gather
    kw, ci_off = {}, None
    if slab_name is not None:
        cells = (cloud_side(dim, cap, 20000) if name.startswith("cloud")
                 else lattice(dim, cap)[0].shape[dim - 2])
        ci_off, faces, band = slab(dim, slab_name, cells)
        kw = dict(ci_off=ci_off, faces=faces, band=band)
    if name.startswith("cloud"):
        grid, sg, c, x0, act, mov, other = cloud(
            dim, cap, 20000, seed=40 + dim + cap, dev=dev,
            alias_x0s=name == "cloud_aliased", ci_off=ci_off)
        repair_k = 64 if name == "cloud_over_k" else 2048
        args = (grid, sg, dim, 0.01, 4, 2.0, repair_k, gather)
        return args, kw, c, x0, act, mov, other, None
    grid, sg, c, x0, _, other, repair_k, can = placed(dim, cap, name, dev,
                                                      ci_off)
    act = torch.ones(x0.shape[0], dtype=torch.bool, device=dev)
    return ((grid, sg, dim, 1.0, 1, 1.0, repair_k, gather), kw, c, x0, act,
            act, other, can)


def _same_bits(a, b) -> bool:
    """Equal dtype and bits (a float's sign of zero and NaN payload too)."""
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _delta(before: dict) -> dict:
    return {k: repair.LAUNCHES[k] - before[k] for k in before}


def _repair_bitwise(args, kw, c, x0, act, mov, other) -> dict:
    """The plan kernels against `plan_plain` on the same CUDA carry (with
    the slab's face test where `kw` holds its faces): every key bitwise;
    when the plan can repair, the apply kernels against `apply_plain` on
    copies of the carry with one other filled storage and the anchors:
    every slot array, the other storage, the new addressing and the
    anchors bitwise.  → (the plan, the kernels' repaired carry or None)."""
    plan, apply = repair.make_repair_tools(*args, **kw)
    plan_p, apply_p = repair.make_repair_tools_plain(
        *args, ci_off=kw.get("ci_off"))
    face_fn = (repair.slab_face_fn(kw["faces"], kw["band"], x0)
               if kw else None)
    before = dict(repair.LAUNCHES)
    got = plan(c, x0, act, mov)
    want = plan_p(c, x0, act, mov, face_fn)
    torch.cuda.synchronize()
    assert _delta(before) == dict(repair_particles=1, repair_movers=1,
                                  repair_lanes=1, repair_copy=0,
                                  repair_patch=0)
    for k in REPAIR_PLAN_KEYS:
        assert _same_bits(got[k], want[k]), k
    if not bool(want["can"]):
        return want, None
    outs = []
    for fn in (apply, apply_p):
        c2, o2 = clone(c, other)
        outs.append((fn(c2, want, [o2], anchors=x0), o2))
    torch.cuda.synchronize()
    assert _delta(before)["repair_patch"] == 1
    (a, oa), (b, ob) = outs
    for k in ("xs", "vs", "acc", "x0s", "rp", "movb", "anchors"):
        assert _same_bits(a[k], b[k]), k
    for k in ("pos", "row_pos", "gcounts"):
        assert _same_bits(getattr(a["addr"], k), getattr(b["addr"], k)), k
    assert _same_bits(oa.feat, ob.feat) and _same_bits(oa.acc, ob.acc)
    return want, a


@pytest.mark.gpu
@pytest.mark.parametrize("name", REPAIR_CARRIES)
@pytest.mark.parametrize("cap", [8, 16])
@pytest.mark.parametrize("dim", [2, 3])
def test_repair_kernels_bitwise_plain_version(dim, cap, name):
    """`_repair_bitwise` on the single-device lattice.  The carries reach
    no risky particle, fewer and more risky than repair_k, a target row 0,
    a mover that finds no free lane, a same-cell re-home onto its own
    lane, movers landing in lanes other movers left, and a cloud of 20,000
    particles with ~300 movers (its x0s its xs, too)."""
    dev = _card()
    args, kw, c, x0, act, mov, other, can = _repair_carry(dim, cap, name,
                                                          dev)
    want, a = _repair_bitwise(args, kw, c, x0, act, mov, other)
    if can is not None:
        assert bool(want["can"]) == can
    if name.startswith("cloud"):
        assert bool(want["can"]) == (name != "cloud_over_k")
    if a is not None:
        # a re-home onto its own lane writes back the values it held
        assert _same_bits(a["xs"], c["xs"]) == (name == "same_cell_rehome")


@pytest.mark.gpu
@pytest.mark.parametrize("case", REPAIR_SLAB_CARRIES)
@pytest.mark.parametrize("cap", [8, 16])
@pytest.mark.parametrize("dim", [2, 3])
def test_repair_slab_kernels_bitwise_plain_version(dim, cap, case):
    """`_repair_bitwise` on a slab's lattice (`torch_repair_carries.SLABS`:
    the index offset, the faces, the band): the hand-placed carries between
    interior faces reach the branches they reach on one device, a mover
    whose anchor lies in a band vetoes the repair, and clouds between
    interior faces and between domain walls."""
    dev = _card()
    slab_name, name = case.split("-")
    args, kw, c, x0, act, mov, other, can = _repair_carry(
        dim, cap, name, dev, slab_name)
    want, _ = _repair_bitwise(args, kw, c, x0, act, mov, other)
    if can is not None:
        assert bool(want["can"]) == (can and slab_name != "veto")
    if slab_name == "walls":
        assert bool(want["can"])


def _dart(dim):
    """A calm block and a small fast dart: a risky minority that the
    resident auto advance repairs."""
    if dim == 2:
        p = port.SimParams()
        lo = (p.wall_eps + 4,) * 2
        return port.calibrate(port.Scene(
            params=p, lo=(0.0, 0.0), hi=(400.0, 400.0),
            blocks=(port.Block(lo=lo, hi=(lo[0] + 60, lo[1] + 100)),
                    port.Block(lo=(250.0, 250.0), hi=(262.0, 262.0),
                               velocity=(420.0, 0.0))), seed=97))
    p = port.SimParams(dim=3, gravity=(0.0, -9.81, 0.0),
                       kernel_norm="proper", eos="tait",
                       integrator="leapfrog", boundary_mode="penalty",
                       dt=4e-4)
    return port.calibrate(port.Scene(
        params=p, lo=(0.0,) * 3, hi=(300.0,) * 3,
        blocks=(port.Block(lo=(20.0,) * 3, hi=(80.0, 100.0, 80.0)),
                port.Block(lo=(200.0, 200.0, 150.0), hi=(210.0, 210.0, 160.0),
                           velocity=(-1500.0, 0.0, 0.0))), seed=74))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [2, 3])
def test_repair_kernels_take_strided_anchors(dim):
    """`_repair_bitwise` with the anchors in column order, as a state
    loaded from a checkpoint holds its x."""
    dev = _card()
    args, kw, c, x0, act, mov, other, _ = _repair_carry(dim, 16, "cloud",
                                                        dev)
    x0_t = x0.T.contiguous().T
    assert not x0_t.is_contiguous()
    want, a = _repair_bitwise(args, kw, c, x0_t, act, mov, other)
    assert a is not None and a["anchors"].is_contiguous()


def _one_rank_world(store):
    """A one-rank gloo group through a file store at `store` (no port)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["single", "slab"])
@pytest.mark.parametrize("dim", [2, 3])
def test_repair_advance_on_card_launches_and_matches_plain(dim, path,
                                                          monkeypatch,
                                                          tmp_path):
    """The resident auto advance with repair_k > 0 on the card, on one
    device and as the slab fast path of a one-rank world (`run(shards=1)`,
    its lattice shifted by its index offset): its plan kernels launch once
    an attempt and its apply kernels once a repair, and its state and
    counters are bitwise a run whose tools are the plain versions, which
    launches no repair kernel."""
    import torch.distributed as dist

    dev = _card()
    scene = _dart(dim)
    calls = {"plan": 0, "apply": 0}

    def plain_tools(*a, faces=None, band=0.0, **kw):
        plan_t, apply_t = repair.make_repair_tools_plain(*a, **kw)

        def plan(c, x0, act, mov):
            calls["plan"] += 1
            return plan_t(c, x0, act, mov, None if faces is None
                          else repair.slab_face_fn(faces, band, x0))

        def apply(*aa, **kk):
            calls["apply"] += 1
            return apply_t(*aa, **kk)

        return plan, apply

    outs = []
    for tools in (None, plain_tools):
        if tools is not None:
            monkeypatch.setattr(port_step, "make_repair_tools", tools)
        repair.reset_launches()
        st = port.init(scene, device=dev)
        kw = dict(steps_per_dispatch=64, sort_every=4, slot_resident=True,
                  repair_k=256, device=dev)
        if path == "single":
            if scene.params.integrator == "leapfrog":
                st = port.prime(scene, st, "pallas", device=dev)
            res = port.make_advance(scene, "pallas", auto_rebuild=True,
                                    **kw)(st)
            res = (res[0], [int(t) for t in res[1:]])
        else:
            _one_rank_world(tmp_path / f"store{len(outs)}")
            try:
                res = (port.run(scene, 64, method="pallas", shards=1,
                                state=st, **kw), [])
            finally:
                dist.destroy_process_group()
        torch.cuda.synchronize()
        outs.append((res, dict(repair.LAUNCHES)))
    ((a, ca), la), ((b, cb), lb) = outs
    assert ca == cb
    for f in ("x", "v", "acc", "rho", "p"):
        assert _same_bits(getattr(a, f), getattr(b, f)), f
    n, repairs = calls["plan"], calls["apply"]
    assert n > 0 and repairs > 0
    if path == "single":
        assert repairs == ca[-1]
    assert la == dict(repair_particles=n, repair_movers=n, repair_lanes=n,
                      repair_copy=repairs, repair_patch=repairs)
    assert all(v == 0 for v in lb.values())
