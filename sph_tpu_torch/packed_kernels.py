"""K3 (packed-row density + EOS) and K4 (packed-row force): wrappers around
the CUDA kernels in `csrc/packed_kernels.cu`, their plain PyTorch versions,
and their launch counts.

K3 replaces `_density_kernel_packed` (sph_tpu/pallas_step.py:969) and K4
`_force_kernel_packed` (sph_tpu/pallas_step.py:1024).  In the packed-row
layout a compacted (z, y) row holds its particles in lanes 0..count-1, so
the candidates of a particle are all the particles of the 3^(D-1) neighbor
rows; compact support annihilates the pairs that are far apart in x.  Per
pair the arithmetic is K1's and K2's (`slot_kernels`):

  K3: ρ_i = m·c_poly6·Σ_j max(h² − r², 0)³ (self included), then p_i = EOS(ρ_i)
  K4: inv_r = 1/√max(r², 1e−24); t = max(h − r²·inv_r, 0);
      s = c_s·t²·inv_r·[r² > 1e−24];
      f_i += (m/2)(p_i+p_j)/max(ρ_j, 1e−12)·s·(x_i−x_j)
             + μ·m/max(ρ_j, 1e−12)·c_v·t·(v_j−v_i)

The TPU kernels always pair against the first 128-lane block of every
neighbor row, the empty dummy row included, because one wide window suits
Mosaic; an empty lane (x = 1e18) contributes exactly 0 to both sums, so the
kernels here visit only the occupied lanes.  Outputs are zero on row 0, rows
past n_occ, blocks with no particle and empty lanes.  A kernel and its plain
version differ only in summation order.

On the card one warp computes a (row, 32-lane chunk) whose lanes hold
particles, staging its candidates in shared memory a tile at a time, and K4
runs the IEEE sqrt/division arithmetic only for candidates within h; the
order of every sum is the first design's, so the results are its bits.
`packed_density_simple` and `packed_force_simple` launch that first design
(one 128-thread block per 128-lane block and row), kept as the yardstick
the warp kernels are held to bit for bit and timed against;
`packed_density_variant` and `packed_force_variant` launch the warp kernels
with other launch choices (warps a block, tile, prefetch, band), for
measuring them.  No path calls either.

A wrapper given CUDA tensors launches its kernel (building it at first use)
or raises; given CPU tensors it runs the plain version.  `LAUNCHES` counts
kernel launches only, none while a CUDA graph is captured.  The kernels'
design and what bounds them on the card is noted in the CUDA source;
PERF.md holds their times.
"""

from __future__ import annotations

import ctypes

import torch

from sph_tpu_torch import _build
from sph_tpu_torch.kernels import kernel_constants
from sph_tpu_torch.params import SimParams
from sph_tpu_torch.physics import eos_pressure
from sph_tpu_torch.slot_kernels import (
    FOUT, LANE, _check, _eos_args, _f32, _raise_on, _stream,
)

#: kernel launches per wrapper since the last `reset_launches()` (none
#: while a CUDA graph is captured)
LAUNCHES = {"packed_density": 0, "packed_force": 0,
            "packed_density_simple": 0, "packed_force_simple": 0,
            "packed_density_variant": 0, "packed_force_variant": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_packed(feat, n_occ, nbr_pos, jb, gcounts, extra=()):
    # no x halo: every block is scanned, and two blocks (row_lanes 256) or
    # one are valid; the cell cap plays no part in packed addressing
    _check(feat, n_occ, nbr_pos, gcounts, LANE,
           extra=(("jb", jb, torch.int32), *extra), min_groups=1)
    if jb.shape != (feat.shape[0],):
        raise ValueError(f"jb has shape {tuple(jb.shape)}")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the same function on the same arrays)
# ---------------------------------------------------------------------------

_LANE_CHUNK = 4096  # i-lanes per pass: bounds the [lanes, R·width] temporaries


def _live_lanes(feat, n_occ, gcounts):
    """(row, lane) int64 of every lane the kernels compute: real particles
    (x < 1e17) in occupied blocks of rows 1..n_occ."""
    n = int(n_occ[0])
    occ = gcounts[1 : n + 1, 0].repeat_interleave(LANE, dim=1) > 0
    r, lane = torch.nonzero(occ & (feat[1 : n + 1, 0] < 1e17), as_tuple=True)
    return r + 1, lane


def _chunks(feat, n_occ, nbr_pos, jb, gcounts):
    """Per chunk of live i-lanes: (row [m], lane [m], neighbor rows nr
    [m, R], candidate lanes j [width]): the lanes of every neighbor row up
    to the widest occupied block count.  `_take` reads the candidates in the
    kernels' order: neighbor row, then lane."""
    rows, lanes_i = _live_lanes(feat, n_occ, gcounts)
    width = int(jb.max()) * LANE if rows.numel() else 0
    j = torch.arange(width, device=feat.device)
    for a in range(0, rows.shape[0], _LANE_CHUNK):
        row, lane = rows[a : a + _LANE_CHUNK], lanes_i[a : a + _LANE_CHUNK]
        yield row, lane, nbr_pos[:, row].T.long(), j


def _take(t, nr, j, c: int):
    """t[nr, c, j] for a [c_rows, C, lanes] array → [m, R·width]."""
    return t[:, c, : j.shape[0]][nr].reshape(nr.shape[0], -1)


def packed_density_plain(feat, n_occ, nbr_pos, jb, gcounts, params: SimParams):
    """Plain version of K3 → rp [c_rows, 2, lanes]."""
    c_rows, _, lanes = feat.shape
    c_p, _, _ = kernel_constants(params.dim, params.h, params.kernel_norm)
    h2, mc = params.h * params.h, params.mass * c_p
    rp = torch.zeros((c_rows, 2, lanes), dtype=feat.dtype, device=feat.device)
    for row, lane, nr, j in _chunks(feat, n_occ, nbr_pos, jb, gcounts):
        r2 = None
        for c in range(params.dim):
            dc = feat[row, c, lane][:, None] - _take(feat, nr, j, c)
            r2 = dc * dc if r2 is None else r2 + dc * dc
        q = torch.clamp(h2 - r2, min=0.0)
        rho = mc * torch.sum(q * q * q, dim=1)
        rp[row, 0, lane] = rho
        rp[row, 1, lane] = eos_pressure(rho, params)
    return rp


def packed_force_plain(feat, rp, n_occ, nbr_pos, jb, gcounts,
                       params: SimParams):
    """Plain version of K4 → f [c_rows, FOUT, lanes]."""
    c_rows, _, lanes = feat.shape
    _, c_s, c_v = kernel_constants(params.dim, params.h, params.kernel_norm)
    h = params.h
    m_half, mu_m = params.mass * 0.5, params.viscosity * params.mass
    f = torch.zeros((c_rows, FOUT, lanes), dtype=feat.dtype, device=feat.device)
    for row, lane, nr, j in _chunks(feat, n_occ, nbr_pos, jb, gcounts):
        dx = [feat[row, c, lane][:, None] - _take(feat, nr, j, c)
              for c in range(params.dim)]
        r2 = dx[0] * dx[0]
        for c in range(1, params.dim):
            r2 = r2 + dx[c] * dx[c]
        inv_r = 1.0 / torch.sqrt(torch.clamp(r2, min=1e-24))
        t = torch.clamp(h - r2 * inv_r, min=0.0)
        s_r = c_s * t * t * inv_r * (r2 > 1e-24)
        inv_rho_j = 1.0 / torch.clamp(_take(rp, nr, j, 0), min=1e-12)
        p_i = rp[row, 1, lane][:, None]
        coef_p = m_half * (p_i + _take(rp, nr, j, 1)) * inv_rho_j * s_r
        coef_v = mu_m * inv_rho_j * (c_v * t)
        for c in range(params.dim):
            v_i = feat[row, 3 + c, lane][:, None]
            f[row, c, lane] = torch.sum(
                coef_p * dx[c] + coef_v * (_take(feat, nr, j, 3 + c) - v_i),
                dim=1,
            )
    return f


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _count(name: str) -> None:
    if not torch.cuda.is_current_stream_capturing():  # a capture runs nothing
        LAUNCHES[name] += 1


def _density(entry, feat, n_occ, nbr_pos, jb, gcounts, params: SimParams,
             choices=()):
    _check_packed(feat, n_occ, nbr_pos, jb, gcounts)
    if feat.device.type == "cpu":
        return packed_density_plain(feat, n_occ, nbr_pos, jb, gcounts, params)
    lib = _build.library("packed_kernels")
    c_rows, _, lanes = feat.shape
    c_p, _, _ = kernel_constants(params.dim, params.h, params.kernel_norm)
    eos = _eos_args(params)
    rp = torch.empty((c_rows, 2, lanes), dtype=torch.float32, device=feat.device)
    rc = getattr(lib, entry)(
        feat.data_ptr(), nbr_pos.data_ptr(), jb.data_ptr(), gcounts.data_ptr(),
        n_occ.data_ptr(), rp.data_ptr(), c_rows, lanes, gcounts.shape[-1],
        nbr_pos.shape[0], params.dim, _f32(params.h * params.h),
        _f32(params.mass * c_p), *eos, *choices, feat.device.index or 0,
        _stream(feat.device),
    )
    _raise_on(rc, entry)
    _count(entry)
    return rp


def _force(entry, feat, rp, n_occ, nbr_pos, jb, gcounts, params: SimParams,
           choices=()):
    _check_packed(feat, n_occ, nbr_pos, jb, gcounts,
                  extra=(("rp", rp, torch.float32),))
    if rp.shape != (feat.shape[0], 2, feat.shape[2]):
        raise ValueError(f"rp has shape {tuple(rp.shape)}")
    if feat.device.type == "cpu":
        return packed_force_plain(feat, rp, n_occ, nbr_pos, jb, gcounts, params)
    lib = _build.library("packed_kernels")
    c_rows, _, lanes = feat.shape
    _, c_s, c_v = kernel_constants(params.dim, params.h, params.kernel_norm)
    f = torch.empty((c_rows, FOUT, lanes), dtype=torch.float32, device=feat.device)
    rc = getattr(lib, entry)(
        feat.data_ptr(), rp.data_ptr(), nbr_pos.data_ptr(), jb.data_ptr(),
        gcounts.data_ptr(), n_occ.data_ptr(), f.data_ptr(), c_rows, lanes,
        gcounts.shape[-1], nbr_pos.shape[0], params.dim, _f32(params.h),
        _f32(c_s), _f32(params.mass * 0.5), _f32(params.viscosity * params.mass),
        _f32(c_v), *choices, feat.device.index or 0, _stream(feat.device),
    )
    _raise_on(rc, entry)
    _count(entry)
    return f


def packed_density(feat, n_occ, nbr_pos, jb, gcounts, params: SimParams):
    """K3 → rp [c_rows, 2, lanes] (rho, EOS p), lane-major."""
    return _density("packed_density", feat, n_occ, nbr_pos, jb, gcounts,
                    params)


def packed_force(feat, rp, n_occ, nbr_pos, jb, gcounts, params: SimParams):
    """K4 → f [c_rows, FOUT, lanes], lane-major (components >= D zero)."""
    return _force("packed_force", feat, rp, n_occ, nbr_pos, jb, gcounts,
                  params)


def packed_density_simple(feat, n_occ, nbr_pos, jb, gcounts,
                          params: SimParams):
    """K3 as first designed (one 128-thread block per 128-lane block and
    row): the warp kernel's yardstick, bitwise its results.  Arguments as
    `packed_density`."""
    return _density("packed_density_simple", feat, n_occ, nbr_pos, jb,
                    gcounts, params)


def packed_force_simple(feat, rp, n_occ, nbr_pos, jb, gcounts,
                        params: SimParams):
    """K4 as first designed: the warp kernel's yardstick, bitwise its
    results.  Arguments as `packed_force`."""
    return _force("packed_force_simple", feat, rp, n_occ, nbr_pos, jb,
                  gcounts, params)


def packed_density_variant(feat, n_occ, nbr_pos, jb, gcounts,
                           params: SimParams, warps: int, tile: int,
                           prefetch: bool, band: bool):
    """The warp K3 with the given launch choices (warps a block 1-8, tile
    32, 64 or 128, `prefetch` of the next tile, `band`: test the last
    coordinate first and skip the candidates beyond h in it), bitwise
    `packed_density`; for measuring the choices."""
    return _density("packed_density_variant", feat, n_occ, nbr_pos, jb,
                    gcounts, params,
                    (warps, tile, int(prefetch), int(band)))


def packed_force_variant(feat, rp, n_occ, nbr_pos, jb, gcounts,
                         params: SimParams, warps: int, tile: int,
                         prefetch: bool, band: bool):
    """The warp K4 with the given launch choices (as
    `packed_density_variant`), bitwise `packed_force`."""
    return _force("packed_force_variant", feat, rp, n_occ, nbr_pos, jb,
                  gcounts, params, (warps, tile, int(prefetch), int(band)))


def default_choices() -> dict:
    """The launch choices `packed_density` and `packed_force` use, by
    kernel ("density", "force")."""
    out = (ctypes.c_int * 8)()
    _build.library("packed_kernels").packed_defaults(out)
    keys = ("warps", "tile", "prefetch", "band")
    return {"density": dict(zip(keys, out[:4])),
            "force": dict(zip(keys, out[4:]))}
