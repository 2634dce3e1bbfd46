"""Plain PyTorch SPH: the reference that decides whether a run is correct.

An independent statement of the physics the configurations name: poly6
density, spiky pressure gradient and Laplacian viscosity (Müller et al.
2003) as force densities, the ideal or Tait equation of state, gravity as
ρ·g, penalty or clamped walls inset by `wall_eps`, static boundary
particles (kind 1) that push but never move, and semi-implicit Euler or
kick-drift-kick leapfrog.  Neighbours are every pair of active particles
closer than h, found anew each step on a uniform cell list: no cap, no
skin, no reuse.  It imports nothing of the program and reads only the
configuration's scene (a plain dict) and the arrays it is handed.

State arrays follow the program's layout (`x`, `v`, `acc` [N, D]; `rho`,
`p` [N]; `kind`, `emit_step` [N] int32; `step` a 0-d int32), as torch
tensors on any device.
"""

from __future__ import annotations

import itertools
import math

import torch


def kernel_constants(dim: int, h: float, norm: str) -> tuple[float, float, float]:
    """(poly6, spiky-gradient, viscosity-Laplacian) normalisations."""
    if dim == 3 or norm == "legacy3d":
        return (315.0 / (64.0 * math.pi * h**9), 45.0 / (math.pi * h**6),
                45.0 / (math.pi * h**6))
    if norm != "proper" or dim != 2:
        raise ValueError(f"no kernel constants for dim={dim}, norm={norm!r}")
    return 4.0 / (math.pi * h**8), 30.0 / (math.pi * h**5), 40.0 / (math.pi * h**5)


def pairs_within(x: torch.Tensor, active: torch.Tensor, h: float,
                 chunk: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, j): every ordered pair of active particles with |x_i - x_j|² < h²,
    the pair i == j included, as int64 indices into `x`."""
    dev = x.device
    idx = torch.nonzero(active).squeeze(1)
    if idx.numel() == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty
    xa = x[idx]
    dim = xa.shape[1]
    cell = h * (1.0 + 1e-5)        # a pair closer than h is never 2 cells apart
    c = torch.floor((xa - xa.min(0).values) / cell).long()
    dims = c.max(0).values + 1
    strides = [1] * dim
    for a in range(dim - 2, -1, -1):
        strides[a] = strides[a + 1] * int(dims[a + 1])
    stride = torch.tensor(strides, device=dev)
    lin = (c * stride).sum(1)
    order = torch.argsort(lin)
    lin, c, xs = lin[order], c[order], xa[order]
    counts = torch.bincount(lin, minlength=int(torch.prod(dims)))
    start = torch.cumsum(counts, 0) - counts
    m = int(counts.max())
    ar = torch.arange(m, device=dev)
    offs = torch.tensor(list(itertools.product((-1, 0, 1), repeat=dim)),
                        device=dev)
    h2 = h * h
    out_i, out_j = [], []
    for a in range(0, len(xs), chunk):
        cs = c[a: a + chunk]
        nc = cs[:, None, :] + offs[None]                       # [P, K, D]
        inb = ((nc >= 0) & (nc < dims)).all(-1)
        nlin = (torch.minimum(nc.clamp(min=0), dims - 1) * stride).sum(-1)
        cnt = torch.where(inb, counts[nlin], 0)
        ok = ar < cnt[..., None]                               # [P, K, M]
        cand = torch.where(ok, start[nlin][..., None] + ar, 0)
        r2 = torch.zeros(cand.shape, dtype=xs.dtype, device=dev)
        for k in range(dim):
            dk = xs[a: a + chunk, k][:, None, None] - xs[cand, k]
            r2 += dk * dk
        pi, pk, pm = torch.nonzero(ok & (r2 < h2), as_tuple=True)
        out_i.append(pi + a)
        out_j.append(cand[pi, pk, pm])
    back = idx[order]
    return back[torch.cat(out_i)], back[torch.cat(out_j)]


class Reference:
    """The scene's physics on `device`, in float32 as configured."""

    def __init__(self, scene: dict, device):
        if scene.get("force_fields"):
            raise NotImplementedError("the reference has no force fields")
        p = scene["params"]
        self.p = p
        self.dim = p["dim"]
        self.h = float(p["h"])
        self.dt = float(p["dt"])
        self.device = torch.device(device)
        self.c_p, self.c_s, self.c_v = kernel_constants(
            self.dim, self.h, p["kernel_norm"])
        self.g = torch.tensor(p["gravity"], device=self.device)
        eps = float(p["wall_eps"])
        self.wall_lo = torch.tensor(scene["lo"], device=self.device) + eps
        self.wall_hi = torch.tensor(scene["hi"], device=self.device) - eps

    def eos(self, rho):
        p = self.p
        if p["eos"] == "ideal":
            pr = p["stiffness"] * (rho - p["rest_density"])
        elif p["eos"] == "tait":
            b = p["sound_speed"] ** 2 * p["rest_density"] / p["tait_gamma"]
            pr = b * ((rho / p["rest_density"]) ** p["tait_gamma"] - 1.0)
        else:
            raise ValueError(f"unknown eos {p['eos']!r}")
        return torch.clamp(pr, min=0.0) if p["pressure_floor"] else pr

    def rho_p_f(self, x, v, active):
        """Density, pressure and force density at positions x (velocities
        v), for the active particles; inactive rows are 0."""
        p, h = self.p, self.h
        n, dim = x.shape
        i, j = pairs_within(x, active, h)
        dx = x[i] - x[j]
        r2 = (dx * dx).sum(1)
        q = torch.clamp(h * h - r2, min=0.0)
        w = (p["mass"] * self.c_p) * q * q * q
        rho = torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, i, w)
        pr = torch.where(active, self.eos(rho), 0.0)
        other = i != j                 # the self pair exerts no force
        i, j, dx, r2 = i[other], j[other], dx[other], r2[other]
        r = torch.sqrt(r2)
        t = torch.clamp(h - r, min=0.0)
        inv_rho_j = 1.0 / torch.clamp(rho[j], min=1e-12)
        press = (p["mass"] * 0.5) * (pr[i] + pr[j]) * inv_rho_j \
            * (self.c_s * t * t / r)
        visc = (p["viscosity"] * p["mass"]) * inv_rho_j * (self.c_v * t)
        fij = press[:, None] * dx + visc[:, None] * (v[j] - v[i])
        f = torch.zeros_like(x).index_add_(0, i, fij)
        f = f + rho[:, None] * self.g
        if p["boundary_mode"] == "penalty":
            k, c = p["wall_stiffness"], p["wall_damping"]
            d_lo = torch.clamp(self.wall_lo - x, min=0.0)
            d_hi = torch.clamp(x - self.wall_hi, min=0.0)
            f = f + (k * d_lo - c * v) * (d_lo > 0) \
                - (k * d_hi + c * v) * (d_hi > 0)
        return rho, pr, f * active[:, None]

    def prime(self, s: dict) -> dict:
        """Fill acc, rho and p from the current positions (leapfrog's start)."""
        act = s["emit_step"] <= s["step"]
        mov = act & (s["kind"] == 0)
        rho, pr, f = self.rho_p_f(s["x"], s["v"], act)
        a = f / torch.clamp(rho, min=1e-12)[:, None]
        return {**s, "acc": torch.where(mov[:, None], a, 0.0),
                "rho": torch.where(act, rho, s["rho"]),
                "p": torch.where(act, pr, s["p"])}

    def resume(self, s: dict, sweeps: int = 3) -> dict:
        """Leapfrog's acc for a state that ended a step: a(x, v½), the
        acceleration at its positions and the velocity before the step's
        closing half-kick v = v½ + dt/2 · a(x, v½), found from x and v
        alone by fixed-point sweeps v½ ← v - dt/2 · a(x, v½).  Velocity
        enters a only through viscosity and wall damping, so each sweep
        shrinks the error some 100-fold at the configured dt.  Clamped
        walls change v after the kick, which this cannot undo."""
        if self.p["integrator"] != "leapfrog":
            return s
        if self.p["boundary_mode"] == "clamp":
            raise NotImplementedError("clamped walls alter v after the kick")
        act = s["emit_step"] <= s["step"]
        m = (act & (s["kind"] == 0))[:, None].float()
        v_half = s["v"]
        for _ in range(sweeps + 1):
            rho, _, f = self.rho_p_f(s["x"], v_half, act)
            a = f / torch.clamp(rho, min=1e-12)[:, None] * m
            v_half = s["v"] - (0.5 * self.dt) * a
        return {**s, "acc": a}

    def step(self, s: dict) -> dict:
        act = s["emit_step"] <= s["step"]
        mov = act & (s["kind"] == 0)
        m = mov[:, None].float()
        x, v, dt = s["x"], s["v"], self.dt
        if self.p["integrator"] == "leapfrog":
            v = v + (0.5 * dt) * s["acc"] * m
            x = x + dt * v * m
            rho, pr, f = self.rho_p_f(x, v, act)
            a = f / torch.clamp(rho, min=1e-12)[:, None]
            v = v + (0.5 * dt) * a * m
        elif self.p["integrator"] == "euler":
            rho, pr, f = self.rho_p_f(x, v, act)
            a = f / torch.clamp(rho, min=1e-12)[:, None]
            v = v + dt * a * m
            x = x + dt * v * m
        else:
            raise ValueError(f"unknown integrator {self.p['integrator']!r}")
        if self.p["boundary_mode"] == "clamp":
            hit = (x < self.wall_lo) | (x > self.wall_hi)
            vc = torch.where(hit, v * self.p["boundary_damping"], v)
            xc = torch.minimum(torch.maximum(x, self.wall_lo), self.wall_hi)
            x = torch.where(mov[:, None], xc, x)
            v = torch.where(mov[:, None], vc, v)
        return {**s, "x": x, "v": v, "acc": torch.where(mov[:, None], a, 0.0),
                "rho": torch.where(act, rho, s["rho"]),
                "p": torch.where(act, pr, s["p"]), "step": s["step"] + 1}

    def advance(self, s: dict, n: int) -> dict:
        for _ in range(n):
            s = self.step(s)
        return s


def frame_scalars(s: dict, mass: float) -> dict:
    """The frame diagnostics of state `s`, in float64: max |v|, min, mean
    and max ρ over the active particles, kinetic energy, active count."""
    act = s["emit_step"] <= s["step"]
    v = s["v"][act].double()
    rho = s["rho"][act].double()
    speed2 = (v * v).sum(1)
    return {"max_speed": float(torch.sqrt(speed2.max())),
            "min_rho": float(rho.min()), "mean_rho": float(rho.mean()),
            "max_rho": float(rho.max()),
            "kinetic_energy": float(0.5 * mass * speed2.sum()),
            "n_active": int(act.sum())}
