"""The exact-zero claim behind the staged K1/K2 (`csrc/slot_kernels.cu`),
held on the host in float32.

The staged kernels skip every candidate slot whose x is at the empty
sentinel (>= 1e17) and keep each i-slot's order: neighbor row, slot-cell,
slot.  That gives the simple kernels' bits only if each skipped term is
exactly +-0 and adding it never changes the accumulator.  Here a
sequential sum in the kernels' order, over the same candidates the plain
versions read (`slot_kernels._chunks`, `_frame_coords`), is taken with and
without the empty candidates, on small clouds whose cells have holes (a
random 10% of the live slots emptied as the resident path's repair leaves
them: x at 1e18, v 0), with fp32 features and with the bf16 frame, and
with K2 reading rho, p = 0 at the empty slots as K1 writes them.  The two
sums must be equal bit for bit.  K2 also skips real candidates whose r^2
is at or above `cut2` (r at least h (1 + 2^-16)), where t = max(h - r, 0)
is 0: its sum without them must be bitwise the full one too.  A host model
of the kernels' window compaction checks that the range each i-slot reads
lists exactly its real candidates, in order.

The warp K3/K4 (`csrc/packed_kernels.cu`) rest on the same claim on packed
rows: in the order neighbor row, block, lane, a sum over every particle of
the neighbor rows (what the first design adds) and the sum over only those
with r^2 < h^2 (K3) or r^2 < cut2 (K4), or over only those whose last
coordinate lies within the band (`band_cut`), are bitwise equal, on packed
clouds with rows over 128 particles.  Host models of the warp kernels'
unit map (one warp per row and 32-lane chunk, chunk-major) and of their
candidate walk check that every live lane is computed once and every
candidate read once, in order.
"""

import numpy as np
import pytest
import torch

import sph_tpu_torch as port
from sph_tpu_torch import neighbors, packed_kernels as pk, pallas_step as ps
from sph_tpu_torch import slot_kernels as sk
from sph_tpu_torch.kernels import kernel_constants

torch.set_num_threads(1)

EMPTY = 1e17
CASES = [(16, 1), (16, 2), (8, 1), (64, 2)]      # (grid cap, xsub)


def _cloud(dim, cap, xsub, bf16, seed):
    """(params, sg, addr, feat) of a random cloud on the slot layout, with
    10% of its live slots emptied as repair leaves them."""
    rng = np.random.default_rng(seed)
    n = 1200 if dim == 2 else 2400
    x = rng.uniform(-10.0, 170.0, (n, dim)).astype(np.float32)
    v = rng.uniform(-5.0, 5.0, (n, dim)).astype(np.float32)
    params = port.SimParams(dim=dim, gravity=(0.0,) * dim,
                            precision="bf16" if bf16 else "fp32")
    scene = port.Scene(params=params, lo=(0.0,) * dim, hi=(160.0,) * dim)
    grid = neighbors.GridSpec.for_scene(scene, cap=cap, xsub=xsub)
    sg = ps.slot_grid(grid)
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    addr = ps.build_addr(xt, torch.ones(n, dtype=torch.bool), grid, sg)
    rows = ps._rel_rows(xt, vt, addr) if bf16 else ps._pack_rows6(xt, vt)
    feat = ps.scatter_slots(addr, rows, sg)
    n_occ = int(addr.n_occ[0])
    r, lane = torch.nonzero(feat[1 : n_occ + 1, 0].float() < EMPTY,
                            as_tuple=True)
    pick = torch.from_numpy(rng.random(r.shape[0]) < 0.1)
    r, lane = r[pick] + 1, lane[pick]
    for c in range(3):
        feat[r, c, lane] = 1e18
        feat[r, 3 + c, lane] = 0.0
    assert int(pick.sum()) > 0
    return params, sg, addr, feat


def _args(sg, addr):
    return addr.n_occ, addr.nbr_pos, addr.gcounts, sg.cap


def _frame(feat, sg):
    return None if feat.dtype == torch.float32 else (
        float(np.float32(sg.cell)), float(np.float32(sg.cell / sg.xsub)))


def _seq(terms, keep=None):
    """Column by column, in the kernels' candidate order, from +0; where
    `keep` is False the column is not added at all."""
    acc = torch.zeros(terms.shape[0], dtype=torch.float32)
    for k in range(terms.shape[1]):
        nxt = acc + terms[:, k]
        acc = nxt if keep is None else torch.where(keep[:, k], nxt, acc)
    return acc


def _force_cut2(h: float) -> float:
    """The staged K2's cut (`force_cut2` in csrc/slot_kernels.cu): the
    square of h (1 + 2^-16), in double, rounded up to fp32."""
    r = float(np.float32(h)) * (1.0 + 1.0 / 65536.0)
    return float(np.nextafter(np.float32(r * r), np.float32(np.inf)))


def _bits(t):
    return t.contiguous().view(torch.int32)


def _candidates(params, sg, addr, feat):
    """Per chunk of live i-slots: (row, lane, nr, j, xi, xj, real), the
    positions as both kernels see them and `real` = the candidate's stored
    x is below the empty sentinel."""
    for row, lane, nr, j in sk._chunks(feat, *_args(sg, addr), sg.xsub):
        xi, xj = sk._frame_coords(feat, row, lane, nr, j, sg.cap, params.dim,
                                  _frame(feat, sg))
        real = sk._take(feat, nr, j, 0) < EMPTY
        yield row, lane, nr, j, xi, xj, real


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cap,xsub", CASES)
@pytest.mark.parametrize("dim", [2, 3])
def test_density_sum_skipping_empty_candidates_is_bitwise(dim, cap, xsub,
                                                          bf16):
    params, sg, addr, feat = _cloud(dim, cap, xsub, bf16, seed=dim * cap + xsub)
    h2 = float(np.float32(params.h * params.h))
    n_empty = 0
    for *_, xi, xj, real in _candidates(params, sg, addr, feat):
        d = xi[0] - xj[0]
        r2 = d * d
        for c in range(1, dim):
            d = xi[c] - xj[c]
            r2 = r2 + d * d
        assert bool(torch.isfinite(r2).all())
        q = torch.clamp(h2 - r2, min=0.0)
        terms = q * q * q
        assert not bool(terms[~real].any())       # each skipped term is +-0
        n_empty += int((~real).sum())
        assert torch.equal(_bits(_seq(terms)), _bits(_seq(terms, real)))
    assert n_empty > 0


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cap,xsub", CASES)
@pytest.mark.parametrize("dim", [2, 3])
def test_force_sum_skipping_empty_and_far_candidates_is_bitwise(dim, cap,
                                                                xsub, bf16):
    params, sg, addr, feat = _cloud(dim, cap, xsub, bf16,
                                    seed=100 + dim * cap + xsub)
    rp = sk.density_plain(feat, *_args(sg, addr), params, xsub,
                          sg.cell if bf16 else None)
    empty = feat[:, 0].float() >= EMPTY
    assert not bool(rp[:, 0][empty].any() or rp[:, 1][empty].any())
    _, c_s, c_v = kernel_constants(dim, params.h, params.kernel_norm)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    h, c_s, c_v = f32(params.h), f32(c_s), f32(c_v)
    m_half, mu_m = f32(params.mass * 0.5), f32(params.viscosity * params.mass)
    cut2 = _force_cut2(params.h)
    assert cut2 > h * h
    n_empty = n_far = 0
    for row, lane, nr, j, xi, xj, real in _candidates(params, sg, addr, feat):
        dx = [xi[c] - xj[c] for c in range(dim)]
        r2 = dx[0] * dx[0]
        for c in range(1, dim):
            r2 = r2 + dx[c] * dx[c]
        near = real & (r2 < cut2)
        inv_r = 1.0 / torch.sqrt(torch.clamp(r2, min=1e-24))
        t = torch.clamp(h - r2 * inv_r, min=0.0)
        s_r = torch.where(r2 > 1e-24, c_s * t * t * inv_r, 0.0)
        inv_rho_j = 1.0 / torch.clamp(sk._take(rp, nr, j, 0), min=1e-12)
        p_i = rp[row, 1, lane][:, None]
        coef_p = m_half * (p_i + sk._take(rp, nr, j, 1)) * inv_rho_j * s_r
        coef_v = mu_m * inv_rho_j * (c_v * t)
        n_empty += int((~real).sum())
        n_far += int((real & ~near).sum())
        assert not bool(t[real & ~near].any())
        for c in range(dim):
            v_i = feat[row, 3 + c, lane].float()[:, None]
            terms = coef_p * dx[c] + coef_v * (sk._take(feat, nr, j, 3 + c)
                                               - v_i)
            assert not bool(terms[~near].any())
            full = _bits(_seq(terms))
            assert torch.equal(full, _bits(_seq(terms, real)))
            assert torch.equal(full, _bits(_seq(terms, near)))
    assert n_empty > 0 and n_far > 0


@pytest.mark.parametrize("cap,xsub", CASES)
@pytest.mark.parametrize("dim", [2, 3])
def test_staged_window_ranges_list_the_real_candidates(dim, cap, xsub):
    """The staged kernels' indexing, modelled on the host: each neighbor
    row's window [g*128 - xm*cap, (g+1)*128 + xm*cap) compacted in lane
    order, start[c] = real slots before window slot-cell c; an i-slot at
    lane l of group g reads [start[l//cap], start[l//cap + 2 xm + 1]).
    That range is exactly the real slots of its slot-cells hx-xm..hx+xm,
    in the simple kernels' order, holes included."""
    _, sg, addr, feat = _cloud(dim, cap, xsub, False, seed=7 * dim + cap)
    scap, xm, lanes = sg.cap, sg.xsub, feat.shape[2]
    width = sk.LANE + 2 * xm * scap
    real = (feat[:, 0] < EMPTY).numpy()
    gcounts, nbr = addr.gcounts[:, 0].numpy(), addr.nbr_pos.numpy()
    checked = 0
    for row in range(1, int(addr.n_occ[0]) + 1):
        for g in range(1, lanes // sk.LANE - 1):
            if gcounts[row, g] == 0:
                continue
            live = np.nonzero(real[row, g * sk.LANE : (g + 1) * sk.LANE])[0]
            lane0 = g * sk.LANE - xm * scap
            for s in range(nbr.shape[0]):
                win = real[nbr[s, row], lane0 : lane0 + width]
                packed = lane0 + np.nonzero(win)[0]
                start = np.concatenate([[0], np.cumsum(win)])[::scap]
                for l in live:
                    c = l // scap
                    got = packed[start[c] : start[c + 2 * xm + 1]]
                    hx = (g * sk.LANE + l) // scap
                    want = [j for j in range((hx - xm) * scap,
                                             (hx + xm + 1) * scap)
                            if real[nbr[s, row], j]]
                    assert got.tolist() == want
                    checked += 1
    assert checked > 0


# (dim, row_lanes, particles): dense rows over 128 particles (and, at row
# lanes 128 and 256, past the row's capacity), and sparse rows of ~30
PACKED_CASES = [(2, 128, 900), (2, 512, 1500), (2, 384, 200), (3, 256, 3000),
                (3, 640, 3000), (3, 384, 700)]
WARP, BLOCK = 32, sk.LANE


def _band_cut(length: float) -> float:
    """The warp kernels' band half-width (`band_cut` in
    csrc/packed_kernels.cu): length (1 + 2^-13), in double, rounded up to
    fp32."""
    r = np.float32(length * (1.0 + 1.0 / 8192.0))
    return float(np.nextafter(r, np.float32(np.inf)))


def _packed_cloud(dim, row_lanes, n, seed):
    """(params, sg, addr, feat, jb) of a random cloud in a narrow tall box
    on the packed-row layout: rows hold up to several hundred particles."""
    rng = np.random.default_rng(seed)
    hi = (48.0, 400.0) if dim == 2 else (48.0, 32.0, 400.0)
    x = rng.uniform(-5.0, 1.0, (n, dim)).astype(np.float32)
    x = (x + 5.0) / 6.0 * (np.asarray(hi, np.float32) + 10.0) - 5.0
    v = rng.uniform(-5.0, 5.0, (n, dim)).astype(np.float32)
    params = port.SimParams(dim=dim, gravity=(0.0,) * dim)
    scene = port.Scene(params=params, lo=(0.0,) * dim, hi=hi)
    grid = neighbors.GridSpec.for_scene(scene, cap=64)
    sg = ps.packed_grid(grid, row_lanes)
    xt, vt = torch.from_numpy(x), torch.from_numpy(v)
    addr = ps.build_addr(xt, torch.ones(n, dtype=torch.bool), grid, sg)
    feat = ps.scatter_slots(addr, ps._pack_rows6(xt, vt), sg)
    return params, sg, addr, feat, ps._jblocks(addr, sg)


def _packed_candidates(params, addr, feat, jb):
    """Per chunk of live i-lanes: (row, lane, nr, j, xi, xj, visited), the
    candidates in the kernels' order (neighbor row, block, lane) over the
    widest row, and `visited` = the lane lies below its block's particle
    count, i.e. the first design adds its term.  Checks that the visited
    lanes are exactly the real ones (a row's particles are a prefix)."""
    gcounts = addr.gcounts[:, 0, :]
    for row, lane, nr, j in pk._chunks(feat, addr.n_occ, addr.nbr_pos, jb,
                                       addr.gcounts):
        m, n_r = nr.shape
        cnt = gcounts[nr[:, :, None], (j // BLOCK)[None, None, :]]
        visited = ((j % BLOCK)[None, None, :] < cnt).reshape(m, -1)
        xi = [feat[row, c, lane][:, None] for c in range(params.dim)]
        xj = [pk._take(feat, nr, j, c) for c in range(params.dim)]
        assert torch.equal(visited, xj[0] < EMPTY)
        yield row, lane, nr, j, xi, xj, visited


@pytest.mark.parametrize("dim,row_lanes,n", PACKED_CASES)
def test_packed_density_sum_skipping_far_candidates_is_bitwise(dim,
                                                               row_lanes, n):
    params, _, addr, feat, jb = _packed_cloud(dim, row_lanes, n, seed=dim + n)
    assert (int(jb.max()) >= 2) == (row_lanes > 128 and n >= 900)
    h2 = float(np.float32(params.h * params.h))
    hx = _band_cut(np.sqrt(h2))
    n_far = n_out = 0
    for *_, xi, xj, visited in _packed_candidates(params, addr, feat, jb):
        d = xi[0] - xj[0]
        r2 = d * d
        for c in range(1, dim):
            d = xi[c] - xj[c]
            r2 = r2 + d * d
        q = torch.clamp(h2 - r2, min=0.0)
        terms = q * q * q
        near = visited & (r2 < h2)
        band = visited & ((xi[-1] - xj[-1]).abs() < hx)
        assert not bool(terms[visited & ~near].any())   # each dropped is +-0
        assert not bool(terms[visited & ~band].any())
        n_far += int((visited & ~near).sum())
        n_out += int((visited & ~band).sum())
        full = _bits(_seq(terms, visited))
        assert torch.equal(full, _bits(_seq(terms, near)))
        assert torch.equal(full, _bits(_seq(terms, band)))
    assert n_far > 0 and n_out > 0


@pytest.mark.parametrize("dim,row_lanes,n", PACKED_CASES)
def test_packed_force_sum_skipping_far_candidates_is_bitwise(dim, row_lanes,
                                                             n):
    params, _, addr, feat, jb = _packed_cloud(dim, row_lanes, n,
                                              seed=100 + dim + n)
    args = (addr.n_occ, addr.nbr_pos, jb, addr.gcounts)
    rp = pk.packed_density_plain(feat, *args, params)
    _, c_s, c_v = kernel_constants(dim, params.h, params.kernel_norm)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    h, c_s, c_v = f32(params.h), f32(c_s), f32(c_v)
    m_half, mu_m = f32(params.mass * 0.5), f32(params.viscosity * params.mass)
    cut2 = _force_cut2(params.h)
    hx = _band_cut(h)
    n_far = n_out = 0
    for row, lane, nr, j, xi, xj, visited in _packed_candidates(params, addr,
                                                                feat, jb):
        dx = [xi[c] - xj[c] for c in range(dim)]
        r2 = dx[0] * dx[0]
        for c in range(1, dim):
            r2 = r2 + dx[c] * dx[c]
        near = visited & (r2 < cut2)
        band = visited & ((xi[-1] - xj[-1]).abs() < hx)
        assert not bool((band < near).any())    # the band holds every near one
        inv_r = 1.0 / torch.sqrt(torch.clamp(r2, min=1e-24))
        t = torch.clamp(h - r2 * inv_r, min=0.0)
        s_r = torch.where(r2 > 1e-24, c_s * t * t * inv_r, 0.0)
        inv_rho_j = 1.0 / torch.clamp(pk._take(rp, nr, j, 0), min=1e-12)
        p_i = rp[row, 1, lane][:, None]
        coef_p = m_half * (p_i + pk._take(rp, nr, j, 1)) * inv_rho_j * s_r
        coef_v = mu_m * inv_rho_j * (c_v * t)
        n_far += int((visited & ~near).sum())
        n_out += int((visited & ~band).sum())
        assert not bool(t[visited & ~near].any())
        for c in range(dim):
            v_i = feat[row, 3 + c, lane][:, None]
            terms = coef_p * dx[c] + coef_v * (pk._take(feat, nr, j, 3 + c)
                                               - v_i)
            assert not bool(terms[visited & ~near].any())
            full = _bits(_seq(terms, visited))
            assert torch.equal(full, _bits(_seq(terms, near)))
            assert torch.equal(full, _bits(_seq(terms, band)))
    assert n_far > 0 and n_out > 0


def _units(c_rows, lanes, n_occ, gcounts):
    """The warp kernels' unit map on the host (`unit_of` in
    csrc/packed_kernels.cu): unit u = chunk * c_rows + row covers lanes
    chunk*32 .. chunk*32+31 of its row, and is live when the row is in
    1..n_occ and the chunk starts below its 128-lane block's count."""
    per_block = BLOCK // WARP
    for u in range(c_rows * (lanes // WARP)):
        chunk, row = divmod(u, c_rows)
        live = (1 <= row <= n_occ and gcounts[row, chunk // per_block]
                > (chunk % per_block) * WARP)
        yield row, range(chunk * WARP, (chunk + 1) * WARP), live


def _tiles(nbr, jb, gcounts, row, tile):
    """The warp kernels' candidate walk on the host (`list_segments`,
    `Fetch::load`): segment k = (s, jg) holds block jg of neighbor row s
    (none past the row's occupied blocks), the segments concatenate into
    one list, and tile after tile of `tile` list indices each lane's slot
    moves its segment cursor forward to the index it loads.  Yields (row,
    lane) per list index, in order."""
    n_groups = gcounts.shape[1]
    nrow, cnt, jgs = [], [], []
    for s in range(nbr.shape[0]):
        nr = int(nbr[s, row])
        for jg in range(n_groups):
            nrow.append(nr)
            jgs.append(jg)
            cnt.append(int(gcounts[nr, jg]) if jg < jb[nr] else 0)
    start = np.concatenate([[0], np.cumsum(cnt)])
    seg = [0] * (tile // WARP)
    for g0 in range(0, int(start[-1]), tile):
        for q in range(min(tile, int(start[-1]) - g0)):
            m, g = q // WARP, g0 + q
            while start[seg[m] + 1] <= g:
                seg[m] += 1
            k = seg[m]
            yield nrow[k], jgs[k] * BLOCK - int(start[k]) + g


@pytest.mark.parametrize("dim,row_lanes,n", PACKED_CASES)
def test_packed_warp_units_and_tiles_cover_each_lane_once(dim, row_lanes, n):
    """Every real lane of rows 1..n_occ lies in exactly one live unit and
    in no dead one; and each live unit's walk, at every tile size, reads
    every particle of its neighbor rows once, in the order neighbor row,
    block, lane (the first design's)."""
    _, sg, addr, feat, jb = _packed_cloud(dim, row_lanes, n, seed=7 + n)
    c_rows, _, lanes = feat.shape
    n_occ = int(addr.n_occ[0])
    gcounts, nbr = addr.gcounts[:, 0].numpy(), addr.nbr_pos.numpy()
    jb = jb.numpy()
    real = (feat[:, 0] < EMPTY).numpy()
    assert n_occ < c_rows - 1 and jb[0] == 0
    seen = np.zeros_like(real, dtype=np.int64)
    live_rows = set()
    for row, lane_range, live in _units(c_rows, lanes, n_occ, gcounts):
        lanes_u = np.asarray(lane_range)
        if not live:
            assert not real[row, lanes_u].any()
            continue
        seen[row, lanes_u] += real[row, lanes_u]
        live_rows.add(row)
    assert np.array_equal(seen[1 : n_occ + 1], real[1 : n_occ + 1])
    assert not real[n_occ + 1 :].any() and not real[0].any()
    for row in sorted(live_rows):
        want = [(int(nbr[s, row]), jl) for s in range(nbr.shape[0])
                for jl in np.nonzero(real[nbr[s, row]])[0]]
        for tile in (32, 64, 128):
            assert list(_tiles(nbr, jb, gcounts, row, tile)) == want
