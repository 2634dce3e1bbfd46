"""K1 (slot density + EOS) and K2 (slot force): wrappers around the CUDA
kernels in `csrc/slot_kernels.cu`, their plain PyTorch versions, and their
launch counts.

K1 replaces `_density_kernel` (sph_tpu/pallas_step.py:750) and K2
`_force_kernel` (sph_tpu/pallas_step.py:837).  Both compute, for every
real particle slot i of an occupied row, a sum over the candidate slots j of
the 3^(D-1) neighbor rows × x-cells hx−1..hx+1 × cap:

  K1: ρ_i = m·c_poly6·Σ_j max(h² − r², 0)³ (self included), then p_i = EOS(ρ_i)
  K2: inv_r = 1/√max(r², 1e−24); t = max(h − r²·inv_r, 0);
      s = c_s·t²·inv_r·[r² > 1e−24];
      f_i += (m/2)(p_i+p_j)/max(ρ_j, 1e−12)·s·(x_i−x_j)
             + μ·m/max(ρ_j, 1e−12)·c_v·t·(v_j−v_i)

Outputs are zero on row 0, rows past n_occ, groups with no real particle,
the halo groups and empty slots.  The kernel and its plain version differ
only in summation order.

A wrapper given CUDA tensors launches its kernel (building it at first use)
or raises; given CPU tensors it runs the plain version.  `LAUNCHES` counts
kernel launches only.  What bounds the kernels on the card, and their
design, is noted in the CUDA source; PERF.md holds their times.
"""

from __future__ import annotations

import numpy as np
import torch

from sph_tpu_torch import _build
from sph_tpu_torch.kernels import kernel_constants
from sph_tpu_torch.params import SimParams
from sph_tpu_torch.physics import eos_pressure

FEAT = 8  # packed feature columns: x(3) | v(3) | spare(2)
FOUT = 4  # force output components: f(3) | pad
LANE = 128

#: kernel launches per wrapper since the last `reset_launches()`; a run
#: reads them to show that its path went through the kernels
LAUNCHES = {"slot_density": 0, "slot_force": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _f32(x: float) -> float:
    """A Python double rounded to fp32, as JAX's weak typing rounds a Python
    constant that meets an fp32 array."""
    return float(np.float32(x))


def _check(feat, n_occ, nbr_pos, gcounts, cap, extra=()):
    dev = feat.device
    for name, t, dtype in (("feat", feat, torch.float32),
                           ("n_occ", n_occ, torch.int32),
                           ("nbr_pos", nbr_pos, torch.int32),
                           ("gcounts", gcounts, torch.int32), *extra):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feat on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    c_rows, n_feat, lanes = feat.shape
    n_groups = gcounts.shape[-1]
    if (n_feat != FEAT or LANE % cap or lanes != n_groups * LANE
            or gcounts.shape != (c_rows, 1, n_groups)
            or nbr_pos.shape[1] != c_rows or n_occ.shape != (1,)
            or n_groups < 3 or c_rows > 65535):
        raise ValueError(
            f"inconsistent slot arrays: feat {tuple(feat.shape)}, gcounts "
            f"{tuple(gcounts.shape)}, nbr_pos {tuple(nbr_pos.shape)}, cap {cap}"
        )


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"sph_tpu_torch: {name} launch failed (cudaError {rc})")


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the same function on the same arrays)
# ---------------------------------------------------------------------------

_SLOT_CHUNK = 16384  # i-slots per pass: bounds the [slots, R·3·cap] temporaries


def _live_slots(feat, n_occ, gcounts):
    """(row, lane) int64 of every slot the kernels compute: real particles
    (x < 1e17) in occupied interior groups of rows 1..n_occ."""
    lanes = feat.shape[2]
    n = int(n_occ[0])
    x0 = feat[1 : n + 1, 0]
    occ = gcounts[1 : n + 1, 0].repeat_interleave(LANE, dim=1) > 0
    occ[:, :LANE] = False          # halo groups 0 and n_groups-1
    occ[:, lanes - LANE :] = False
    r, lane = torch.nonzero(occ & (x0 < 1e17), as_tuple=True)
    return r + 1, lane


def _chunks(feat, n_occ, nbr_pos, gcounts, cap: int):
    """Per chunk of live i-slots: (row [m], lane [m], neighbor rows nr
    [m, R], candidate lanes j [m, 3·cap] over the x-cells hx−1..hx+1).
    `_take` reads the candidates in the kernels' order: neighbor row, then
    x-cell, then slot."""
    rows, lanes_i = _live_slots(feat, n_occ, gcounts)
    off = torch.arange(3 * cap, device=feat.device)
    for a in range(0, rows.shape[0], _SLOT_CHUNK):
        row, lane = rows[a : a + _SLOT_CHUNK], lanes_i[a : a + _SLOT_CHUNK]
        nr = nbr_pos[:, row].T.long()                      # [m, R]
        j = (lane // cap - 1)[:, None] * cap + off[None, :]  # [m, 3·cap]
        yield row, lane, nr, j


def _take(t, nr, j, c: int):
    """t[nr, c, j] for a [c_rows, C, lanes] array → [m, R·3·cap]."""
    _, n_c, lanes = t.shape
    idx = (nr[:, :, None] * n_c + c) * lanes + j[:, None, :]
    return t.reshape(-1)[idx.reshape(idx.shape[0], -1)]


def density_plain(feat, n_occ, nbr_pos, gcounts, cap: int, params: SimParams):
    """Plain version of K1 → rp [c_rows, 2, lanes]."""
    c_rows, _, lanes = feat.shape
    c_p, _, _ = kernel_constants(params.dim, params.h, params.kernel_norm)
    h2, mc = params.h * params.h, params.mass * c_p
    rp = torch.zeros((c_rows, 2, lanes), dtype=feat.dtype, device=feat.device)
    for row, lane, nr, j in _chunks(feat, n_occ, nbr_pos, gcounts, cap):
        r2 = None
        for c in range(params.dim):
            dc = feat[row, c, lane][:, None] - _take(feat, nr, j, c)
            r2 = dc * dc if r2 is None else r2 + dc * dc
        q = torch.clamp(h2 - r2, min=0.0)
        rho = mc * torch.sum(q * q * q, dim=1)
        rp[row, 0, lane] = rho
        rp[row, 1, lane] = eos_pressure(rho, params)
    return rp


def force_plain(feat, rp, n_occ, nbr_pos, gcounts, cap: int,
                params: SimParams):
    """Plain version of K2 → f [c_rows, FOUT, lanes]."""
    c_rows, _, lanes = feat.shape
    _, c_s, c_v = kernel_constants(params.dim, params.h, params.kernel_norm)
    h = params.h
    m_half, mu_m = params.mass * 0.5, params.viscosity * params.mass
    f = torch.zeros((c_rows, FOUT, lanes), dtype=feat.dtype, device=feat.device)
    for row, lane, nr, j in _chunks(feat, n_occ, nbr_pos, gcounts, cap):
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


def slot_density(feat, n_occ, nbr_pos, gcounts, cap: int, params: SimParams):
    """K1 → rp [c_rows, 2, lanes] (rho, EOS p), lane-major."""
    _check(feat, n_occ, nbr_pos, gcounts, cap)
    if feat.device.type == "cpu":
        return density_plain(feat, n_occ, nbr_pos, gcounts, cap, params)
    lib = _build.library("slot_kernels")
    c_rows, _, lanes = feat.shape
    c_p, _, _ = kernel_constants(params.dim, params.h, params.kernel_norm)
    tait = params.eos == "tait"
    if not tait and params.eos != "ideal":
        raise ValueError(f"unknown eos {params.eos!r}")
    b = params.sound_speed**2 * params.rest_density / params.tait_gamma
    rp = torch.empty((c_rows, 2, lanes), dtype=torch.float32, device=feat.device)
    rc = lib.slot_density(
        feat.data_ptr(), nbr_pos.data_ptr(), gcounts.data_ptr(),
        n_occ.data_ptr(), rp.data_ptr(), c_rows, lanes, gcounts.shape[-1],
        cap, nbr_pos.shape[0], params.dim, _f32(params.h * params.h),
        _f32(params.mass * c_p), int(tait), int(params.pressure_floor),
        _f32(params.stiffness), _f32(params.rest_density), _f32(b),
        _f32(params.tait_gamma), feat.device.index or 0, _stream(feat.device),
    )
    _raise_on(rc, "slot_density")
    LAUNCHES["slot_density"] += 1
    return rp


def slot_force(feat, rp, n_occ, nbr_pos, gcounts, cap: int, params: SimParams):
    """K2 → f [c_rows, FOUT, lanes], lane-major (components >= D zero)."""
    _check(feat, n_occ, nbr_pos, gcounts, cap,
           extra=(("rp", rp, torch.float32),))
    if rp.shape != (feat.shape[0], 2, feat.shape[2]):
        raise ValueError(f"rp has shape {tuple(rp.shape)}")
    if feat.device.type == "cpu":
        return force_plain(feat, rp, n_occ, nbr_pos, gcounts, cap, params)
    lib = _build.library("slot_kernels")
    c_rows, _, lanes = feat.shape
    _, c_s, c_v = kernel_constants(params.dim, params.h, params.kernel_norm)
    f = torch.empty((c_rows, FOUT, lanes), dtype=torch.float32, device=feat.device)
    rc = lib.slot_force(
        feat.data_ptr(), rp.data_ptr(), nbr_pos.data_ptr(), gcounts.data_ptr(),
        n_occ.data_ptr(), f.data_ptr(), c_rows, lanes, gcounts.shape[-1], cap,
        nbr_pos.shape[0], params.dim, _f32(params.h), _f32(c_s),
        _f32(params.mass * 0.5), _f32(params.viscosity * params.mass),
        _f32(c_v), feat.device.index or 0, _stream(feat.device),
    )
    _raise_on(rc, "slot_force")
    LAUNCHES["slot_force"] += 1
    return f
