"""Smoothing kernels: poly6 (density), spiky gradient (pressure), viscosity
Laplacian (port of `sph_tpu/kernels.py`; Müller et al. 2003).

Branchless functions of r² on tensors of any batch shape.  Compact support
is enforced with `clamp(·, min=0)` rather than a select on distance, the
same form the slot kernels in `csrc/slot_kernels.cu` use.

Normalization conventions: "proper" uses dimension-correct constants,
"legacy3d" the 3D constants in every dimension (a tutorial-family habit).
For dim == 3 the two coincide.
"""

from __future__ import annotations

import math

import torch


def kernel_constants(dim: int, h: float, norm: str) -> tuple[float, float, float]:
    """(poly6, spiky-gradient magnitude, viscosity-Laplacian) normalizations.

    W_poly6(r)   = C_p · (h²−r²)³          0 ≤ r ≤ h
    ∇W_spiky(r)  = −C_s · (h−r)² · r̂
    ∇²W_visc(r)  =  C_v · (h−r)
    """
    if norm not in ("proper", "legacy3d"):
        raise ValueError(f"kernel_norm must be 'proper' or 'legacy3d', got {norm!r}")
    use3d = dim == 3 or norm == "legacy3d"
    if use3d:
        c_poly6 = 315.0 / (64.0 * math.pi * h**9)
        c_spiky = 45.0 / (math.pi * h**6)
        c_visc = 45.0 / (math.pi * h**6)
    else:
        if dim != 2:
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        c_poly6 = 4.0 / (math.pi * h**8)
        c_spiky = 30.0 / (math.pi * h**5)
        c_visc = 40.0 / (math.pi * h**5)
    return c_poly6, c_spiky, c_visc


def poly6(r2: torch.Tensor, h: float, c_poly6: float) -> torch.Tensor:
    """Density kernel W_poly6(r², h). Zero for r² ≥ h² (branchless)."""
    q = torch.clamp(h * h - r2, min=0.0)
    return c_poly6 * q * q * q


def spiky_grad_scale(r: torch.Tensor, h: float, c_spiky: float,
                     eps: float = 1e-12) -> torch.Tensor:
    """Scalar s(r) such that ∇W_spiky(d) = −s(r) · d for d = x_i − x_j.

    s(r) = C_s (h−r)² / r, zero outside support, guarded at r → 0 (the j = i
    self-pair and coincident particles contribute no pressure force)."""
    t = torch.clamp(h - r, min=0.0)
    return c_spiky * t * t / torch.clamp(r, min=eps) * (r > eps)


def pair_scales(r2: torch.Tensor, h: float, c_spiky: float, c_visc: float,
                eps: float = 1e-24) -> tuple[torch.Tensor, torch.Tensor]:
    """(spiky-gradient scale s(r), viscosity Laplacian) from r² via ONE
    rsqrt: r = r²·rsqrt(r²) and 1/r = rsqrt(r²).  The (r² > eps) factor
    zeroes the j = i self-pair (s(0) must be exactly 0, not
    c_s·h²·rsqrt(eps)).  Every neighbor path uses this one form."""
    inv_r = torch.rsqrt(torch.clamp(r2, min=eps))
    t = torch.clamp(h - r2 * inv_r, min=0.0)
    s = c_spiky * t * t * inv_r * (r2 > eps)
    return s, c_visc * t


def visc_lap(r: torch.Tensor, h: float, c_visc: float) -> torch.Tensor:
    """Viscosity Laplacian ∇²W_visc(r, h). Zero outside support."""
    return c_visc * torch.clamp(h - r, min=0.0)


def spiky_w(r: torch.Tensor, h: float, dim: int, norm: str) -> torch.Tensor:
    """W_spiky itself, whose radial derivative `spiky_grad_scale` gives;
    the paths use only its gradient."""
    use3d = dim == 3 or norm == "legacy3d"
    c = 15.0 / (math.pi * h**6) if use3d else 10.0 / (math.pi * h**5)
    t = torch.clamp(h - r, min=0.0)
    return c * t * t * t
