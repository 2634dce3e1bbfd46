"""SPH physics: density, EOS, forces, body forces, boundaries (port of
`sph_tpu/physics.py`).

The pair-level terms (`density_contrib`, `force_contrib`) are shared by the
naive O(N²) path here and mirrored term by term in the slot kernels
(`pallas_step`, `csrc/slot_kernels.cu`), so every neighbor path evaluates
one definition of the physics.

Conventions: forces are force densities (acceleration is f/ρᵢ); gravity
enters as ρᵢ·g; the pairwise pressure force is antisymmetric.  Python-float
constants multiply fp32 tensors as fp32 values, as JAX's weak typing does.
"""

from __future__ import annotations

import torch

from sph_tpu_torch.kernels import kernel_constants, pair_scales, poly6
from sph_tpu_torch.params import SimParams
from sph_tpu_torch.platform import device_const


def density_contrib(r2, mask, params: SimParams):
    """Per-pair density contribution m·W_poly6; includes the j = i self-term
    (r = 0 is inside support).  `mask` zeroes invalid candidates."""
    c_p, _, _ = kernel_constants(params.dim, params.h, params.kernel_norm)
    return params.mass * poly6(r2, params.h, c_p) * mask


def force_contrib(dx, r2, v_i, v_j, p_i, p_j, rho_j, mask, params: SimParams):
    """Per-pair force density on i from j (pressure + viscosity).

    f_press = −m (pᵢ+pⱼ)/(2ρⱼ) ∇W_spiky   with ∇W_spiky(d) = −s(r)·d
    f_visc  =  μ m (vⱼ−vᵢ)/ρⱼ ∇²W_visc
    dx = xᵢ − xⱼ, shape [..., D]; scalars [...].
    """
    _, c_s, c_v = kernel_constants(params.dim, params.h, params.kernel_norm)
    inv_rho_j = mask / torch.clamp(rho_j, min=1e-12)
    s, lap = pair_scales(r2, params.h, c_s, c_v)
    f_press = (params.mass * 0.5) * ((p_i + p_j) * inv_rho_j * s)[..., None] * dx
    f_visc = (params.viscosity * params.mass) * (
        inv_rho_j * lap
    )[..., None] * (v_j - v_i)
    return f_press + f_visc


def eos_pressure(rho, params: SimParams):
    """EOS: ideal-gas p = k(ρ−ρ₀) or Tait p = (c₀²ρ₀/γ)((ρ/ρ₀)^γ − 1)."""
    if params.eos == "ideal":
        p = params.stiffness * (rho - params.rest_density)
    elif params.eos == "tait":
        b = params.sound_speed**2 * params.rest_density / params.tait_gamma
        p = b * ((rho / params.rest_density) ** params.tait_gamma - 1.0)
    else:
        raise ValueError(f"unknown eos {params.eos!r}")
    if params.pressure_floor:
        p = torch.clamp(p, min=0.0)
    return p


# ---------------------------------------------------------------------------
# Naive O(N²) all-pairs path — the correctness oracle
# ---------------------------------------------------------------------------


def density_naive(x, active, params: SimParams):
    """ρᵢ = Σⱼ m W(rᵢⱼ) over active j; inactive i get ρ = ρ₀ (placeholder)."""
    dx = x[:, None, :] - x[None, :, :]
    r2 = torch.sum(dx * dx, dim=-1)
    mask = active[None, :].to(x.dtype)
    rho = torch.sum(density_contrib(r2, mask, params), dim=1)
    return torch.where(active, rho, torch.full_like(rho, params.rest_density))


def forces_naive(x, v, rho, p, active, params: SimParams):
    """Pairwise pressure+viscosity force densities, all-pairs. [N, D]."""
    dx = x[:, None, :] - x[None, :, :]
    r2 = torch.sum(dx * dx, dim=-1)
    mask = active[None, :].to(x.dtype)
    f = force_contrib(
        dx, r2, v[:, None, :], v[None, :, :], p[:, None], p[None, :],
        rho[None, :], mask, params,
    )
    return torch.sum(f, dim=1) * active[:, None].to(x.dtype)


# ---------------------------------------------------------------------------
# Body forces and boundaries
# ---------------------------------------------------------------------------


def gravity_force(rho, params: SimParams):
    """f_grav = ρ·g (force-density convention)."""
    g = device_const(tuple(params.gravity), rho.dtype, rho.device)
    return rho[:, None] * g[None, :]


def force_field_force(x, step, fields):
    """Scheduled external force probes: radial force density s·(1 − r/R)
    toward/away from each field center, zero outside R or outside the
    field's step window.  `step` is a 0-d int tensor (no host sync)."""
    f = torch.zeros_like(x)
    for ff in fields:
        c = device_const(tuple(ff.pos), x.dtype, x.device)
        dx = c[None, :] - x
        r = torch.sqrt(torch.sum(dx * dx, dim=-1))
        # an fp32 0-d tensor divisor, as the reference's weakly typed
        # constant: PyTorch's CUDA division by a Python float multiplies by
        # fp32(1/radius) rounded from double instead, which differs
        fall = torch.clamp(
            1.0 - r / device_const(ff.radius, x.dtype, x.device), min=0.0)
        live = ((step >= ff.start_step) & (step < ff.stop_step)).to(x.dtype)
        dirn = dx / torch.clamp(r, min=1e-6)[:, None]
        f = f + (ff.strength * live) * fall[:, None] * dirn
    return f


def _inset_walls(lo, hi, x, params: SimParams):
    lo = device_const(tuple(lo), x.dtype, x.device) + params.wall_eps
    hi = device_const(tuple(hi), x.dtype, x.device) - params.wall_eps
    return lo, hi


def wall_penalty_force(x, v, lo, hi, params: SimParams):
    """Penalty spring-damper per wall: penetration d > 0 past the inset
    wall ⇒ f += (k·d − c·v_n)·n̂."""
    lo, hi = _inset_walls(lo, hi, x, params)
    k, c = params.wall_stiffness, params.wall_damping
    d_lo = torch.clamp(lo[None, :] - x, min=0.0)   # penetration past min walls
    d_hi = torch.clamp(x - hi[None, :], min=0.0)   # penetration past max walls
    # min wall: n̂ = +e_a, v_n = v;  max wall: n̂ = −e_a, v_n = −v
    return (k * d_lo - c * v) * (d_lo > 0) - (k * d_hi - c * (-v)) * (d_hi > 0)


def clamp_boundary(x, v, lo, hi, params: SimParams):
    """Clamp position to the inset wall and scale the velocity on the hit
    axis by `boundary_damping` (default −0.5)."""
    lo, hi = _inset_walls(lo, hi, x, params)
    hit = (x < lo[None, :]) | (x > hi[None, :])
    v = torch.where(hit, v * params.boundary_damping, v)
    x = torch.minimum(torch.maximum(x, lo[None, :]), hi[None, :])
    return x, v
