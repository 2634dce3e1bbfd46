"""The roofline arithmetic of the slot kernels K1 (density) and K2 (force):
published peaks, and the operations and bytes the function needs, counted
from the physics and not from the program's layout.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet), HBM3 at 3.35 TB/s and
67 TFLOP/s in float32 outside the tensor cores, both at the full 700 W.

Operations a pair within h (r² < h²), fp32, counted from the kernels'
arithmetic: r² takes dim subtractions, dim multiplications and dim - 1
additions; the density term h² - r², a max, q³ (2 multiplications) and
the accumulation (5 in all); the force term max + sqrt + divide, r²·1/r,
h - r, a max, c_s·t·t/r (3), p_i + p_j, the pressure coefficient (3), the
viscosity coefficient (3) (16 in all), and per component a subtraction, 2
multiplications and 2 additions (5·dim); once a particle, the force's
1/max(ρ_j, 1e-12) (2).  Density pairs include i == j (its self term);
force pairs do not (the self pair exerts no force).

Bytes: each active particle's inputs read once and outputs written once,
at 4 bytes a value: K1 reads x and writes ρ and p; K2 reads x, v, ρ and p
and writes f.
"""

from __future__ import annotations

import re

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

K1 = re.compile(r"\bstaged_kernel<\s*\d+\s*,\s*[\w:]+\s*,\s*false\s*>")
K2 = re.compile(r"\bstaged_kernel<\s*\d+\s*,\s*[\w:]+\s*,\s*true\s*>")


def density_ops(dim: int, near: int) -> int:
    return near * (3 * dim - 1 + 5)


def force_ops(dim: int, near: int, particles: int) -> int:
    return (near - particles) * (3 * dim - 1 + 16 + 5 * dim) + 2 * particles


def density_bytes(dim: int, particles: int) -> int:
    return particles * (dim + 2) * 4


def force_bytes(dim: int, particles: int) -> int:
    return particles * (3 * dim + 2) * 4


def bound_s(ops: int, nbytes: int) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S)


def kernel_roofline_pct(obs, pattern, ops, nbytes) -> float | None:
    """Σ bound / Σ device time over the launches whose name matches
    `pattern`, in %; each launch bounded on the pairs of its frame's
    starting state.  None when the trace holds no such launch."""
    bound = busy = 0.0
    for name, t0, dur in obs.trace.kernels:
        if pattern.search(name):
            fp = obs.pairs[obs.trace.frame_of(t0)]
            bound += bound_s(ops(obs.dim, fp), nbytes(obs.dim, fp))
            busy += dur * 1e-9
    return 100.0 * bound / busy if busy > 0 else None
