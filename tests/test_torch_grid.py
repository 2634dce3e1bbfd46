"""The grid method of the port (`sph_tpu_torch.neighbors`: `build_tiles`,
`_neighbor_rows`, `cell_overflow`, `grid_rho_p_f`, and `method="grid"`
through `make_step`/`run`) against the reference's, on the same numpy
inputs, in the pattern of tests/test_grid_equiv.py.

Integer structures (tiles, neighbor rows, overflow) are exactly equal;
the neighbor sets equal naive's exactly; rho and p agree within
rtol=1e-5, atol=1e-6, and f within 3e-5 of its largest component, the
reference suite's own tolerances between paths whose sums run in other
orders (tests/test_pallas_equiv.py:32, 55-57): a force component that is a
near-zero difference of large terms carries their rounding.  A trajectory
agrees in x and rho within rtol=1e-5, atol=1e-6 and in v as ROADMAP.md
Queue 3 item 7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu_torch as port
from helpers import small_scene
from sph_tpu import neighbors as ref_nb
from sph_tpu.params import Scene as RefScene
from sph_tpu.params import SimParams as RefSimParams
from sph_tpu_torch import neighbors
from sph_tpu_torch.params import Scene, SimParams
from test_grid_equiv import CASES, _neighbor_sets_naive
from test_torch_resident import CPU, _agree, _pair

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
FTOL = 3e-5


def _close(ours, ref, what):
    """rho and p within TOL, f within FTOL of its scale."""
    for name, a, b in zip(("rho", "p", "f"), ours, ref):
        a, b = a.numpy(), np.asarray(b)
        if name == "f":
            scale = np.max(np.abs(b)) + 1e-9
            assert np.max(np.abs(a - b)) / scale < FTOL, (what, name)
        else:
            assert np.allclose(a, b, **TOL), (what, name)


def _cloud(case: str, dim: int, n: int = 200):
    x, _ = CASES[case](n, dim)
    x = x[:, :dim].astype(np.float32)
    v = np.random.default_rng(17).uniform(-5, 5, x.shape).astype(np.float32)
    active = np.ones(n, bool)
    active[180:] = False
    return x, v, active


def _grids(dim: int, **kw):
    """(port GridSpec, reference GridSpec) of the same 200-wide box."""
    p = SimParams(dim=dim, gravity=(0.0,) * dim, kernel_norm="proper")
    rp = RefSimParams(dim=dim, gravity=(0.0,) * dim, kernel_norm="proper")
    ours = neighbors.GridSpec.for_scene(
        Scene(params=p, lo=(0.0,) * dim, hi=(200.0,) * dim), **kw)
    ref = ref_nb.GridSpec.for_scene(
        RefScene(params=rp, lo=(0.0,) * dim, hi=(200.0,) * dim), **kw)
    return p, rp, ours, ref


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dim", [2, 3])
def test_tiles_and_neighbor_rows_equal_reference(case, dim):
    x, _, active = _cloud(case, dim)
    _, _, g, rg = _grids(dim, cap=8)   # cap 8: the dense cases overflow
    assert (g.n_rows, g.empty_row, g.dump_row, g.n_offsets) == (
        rg.n_rows, rg.empty_row, rg.dump_row, rg.n_offsets)
    ci, flat = neighbors.cell_index(torch.from_numpy(x),
                                    torch.from_numpy(active), g)
    rci, rflat = ref_nb.cell_index(jnp.asarray(x), jnp.asarray(active), rg)
    tile, order, starts, counts = neighbors.build_tiles(flat, g)
    rtile, rorder, rstarts, rcounts = ref_nb.build_tiles(rflat, rg)
    assert np.array_equal(tile.numpy(), np.asarray(rtile))
    assert np.array_equal(order.numpy(), np.asarray(rorder))
    assert np.array_equal(counts.numpy(), np.asarray(rcounts))
    assert np.array_equal(starts.numpy(), np.asarray(rstarts))
    rows = neighbors._neighbor_rows(ci, g)
    assert np.array_equal(rows.numpy(), np.asarray(ref_nb._neighbor_rows(rci, rg)))
    over = neighbors.cell_overflow(torch.from_numpy(x),
                                   torch.from_numpy(active), g)
    assert int(over) == int(ref_nb.cell_overflow(
        jnp.asarray(x), jnp.asarray(active), rg))


def _neighbor_sets_port(x, active, grid):
    """Dense [N, N] adjacency recovered from the port's candidate tiles."""
    n = x.shape[0]
    ci, flat = neighbors.cell_index(torch.from_numpy(x),
                                    torch.from_numpy(active), grid)
    tile = neighbors.build_tiles(flat, grid)[0]
    idx = neighbors._candidates(ci, tile, grid).numpy()
    xj = np.concatenate([x, np.full((1, x.shape[1]), 1e18, np.float32)])[idx]
    r2 = np.sum((x[:, None, :] - xj) ** 2, axis=-1)
    keep = ((idx < n) & (r2 < grid.cell * grid.cell)).ravel()
    adj = np.zeros((n, n), bool)
    adj[np.repeat(np.arange(n), idx.shape[1])[keep], idx.ravel()[keep]] = True
    return adj & active[:, None]


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dim", [2, 3])
def test_neighbor_sets_equal_naive(case, dim):
    x, _, active = _cloud(case, dim)
    p, _, g, _ = _grids(dim, cap=256)   # cap >= n: no overflow anywhere
    got = _neighbor_sets_port(x, active, g)
    assert np.array_equal(got, _neighbor_sets_naive(x, active, p.h)), case


def test_overflow_detection():
    p = SimParams(gravity=(0.0, 0.0))
    g = neighbors.GridSpec.for_scene(
        Scene(params=p, lo=(0.0, 0.0), hi=(100.0, 100.0)), cap=8)
    x = torch.full((64, 2), 50.0)
    assert int(neighbors.cell_overflow(x, torch.ones(64, dtype=torch.bool),
                                       g)) == 64 - 8


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dim", [2, 3])
def test_grid_rho_p_f_matches_reference(case, dim):
    x, v, active = _cloud(case, dim)
    p, rp, g, rg = _grids(dim, cap=256)
    ours = neighbors.grid_rho_p_f(torch.from_numpy(x), torch.from_numpy(v),
                                  torch.from_numpy(active), p, g)
    ref = ref_nb.grid_rho_p_f(jnp.asarray(x), jnp.asarray(v),
                              jnp.asarray(active), rp, rg)
    _close(ours, ref, case)
    # the split phases give bitwise the fused call's values
    xt, vt, at = (torch.from_numpy(a) for a in (x, v, active))
    assert torch.equal(neighbors.grid_density(xt, at, p, g), ours[0])
    assert torch.equal(neighbors.grid_forces(xt, vt, ours[0], ours[1], at,
                                             p, g), ours[2])


def test_graceful_drop_matches_reference():
    """A tiny cap drops the same particles from the same tiles in both
    packages; every value stays finite."""
    rs, rst, scene, ost = _pair(small_scene(dim=2, seed=21))
    g = neighbors.GridSpec.for_scene(scene, cap=2)
    rg = ref_nb.GridSpec.for_scene(rs, cap=2)
    assert int(neighbors.cell_overflow(ost.x, ost.active, g)) > 0
    ours = neighbors.grid_rho_p_f(ost.x, ost.v, ost.active, scene.params, g)
    ref = ref_nb.grid_rho_p_f(rst.x, rst.v, rst.active, rs.params, rg)
    assert all(bool(torch.isfinite(a).all()) for a in ours)
    _close(ours, ref, "cap 2")


def test_chunks_change_no_result(monkeypatch):
    """Particle chunks small enough to split the cloud give bitwise the
    unchunked rho, p and f: a chunk changes no neighbor set and no order
    of a sum."""
    x, v, active = _cloud("clustered", 3)
    p, _, g, _ = _grids(3, cap=256)
    args = (torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(active),
            p, g)
    whole = neighbors.grid_rho_p_f(*args)
    per = g.n_offsets * g.cap * (2 * 3 + 2) * 4
    monkeypatch.setattr(neighbors, "GATHER_BUDGET", 37 * per)
    assert len(neighbors._spans(x.shape[0], g, 3)) == 6
    for a, b in zip(neighbors.grid_rho_p_f(*args), whole):
        assert torch.equal(a, b)


def test_grid_trajectory_matches_reference():
    """20 grid steps from the same state (one 20-step dispatch each): x and
    rho within rtol=1e-5, atol=1e-6.  v is held as the trajectories of
    tests/test_torch_step.py hold it (1e-3 of its scale), not as Queue 3
    item 7: after 20 steps it differs by 2.3e-6 of the largest speed, as
    the port's naive path does from the reference's naive path (both
    ~1.4e-4 absolute), so that is the growth of the summation-order
    difference and not the grid method's."""
    rs, rst, scene, ost = _pair(small_scene(dim=2, seed=20))
    ref = sph_tpu.make_advance(rs, "grid", steps_per_dispatch=20)(rst)
    ours = port.make_advance(scene, "grid", steps_per_dispatch=20, **CPU)(ost)
    assert np.array_equal(ours.active.numpy(), np.asarray(ref.active))
    assert int(ours.step) == int(ref.step) == 20
    for f in ("x", "rho"):
        assert np.allclose(getattr(ours, f).numpy(),
                           np.asarray(getattr(ref, f)), **TOL), f
    vr = np.asarray(ref.v)
    assert np.max(np.abs(ours.v.numpy() - vr)) / np.max(np.abs(vr)) < 1e-3


def test_run_grid_primes_and_matches_reference():
    """`run(method="grid")` with a leapfrog prime at step 0, 3D."""
    ref_scene = small_scene(dim=3, integrator="leapfrog", dt=4e-4, seed=22)
    rs, rst, scene, ost = _pair(ref_scene)
    ref = sph_tpu.run(rs, 8, method="grid", steps_per_dispatch=8, state=rst)
    ours = port.run(scene, 8, method="grid", steps_per_dispatch=8, state=ost,
                    **CPU)
    _agree(ref, ours, "run grid, leapfrog 3D")
