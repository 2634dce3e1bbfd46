"""The comparison that decides `correct`.

Two kinds of numbers, each beside its limit:

- the guarantees the configuration states, read from the frame
  diagnostics the program fetched at the end of every frame of the window:
  `lost` (the seeded active count less the reported one, exactly 0),
  `rho_dev` (the largest |mean ρ / ρ₀ - 1|) and `max_speed` (the largest
  max |v|);
- the reference's verdict on the frames drawn from the seed, in the last
  pass of the window.  From the state the frame started from (the seeded
  state itself for frame 0, which the reference primes on its own; the
  positions and velocities the program ended the previous frame with
  otherwise, from which the reference works out leapfrog's acceleration
  again) the reference runs the frame's steps and is compared with the
  state the
  program ended the frame with: `x_gap` (the largest |Δx| / h), `v_gap`
  (the largest |Δv| / c₀), `rho_gap` (the largest |Δρ| / ρ₀), over the
  active particles, and `diag_gap` (the largest relative gap between the
  diagnostics the program fetched and the same scalars worked out in
  float64 from the state it ended the frame with).
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.sph import Reference, frame_scalars

DIAG = ("max_speed", "min_rho", "mean_rho", "max_rho", "kinetic_energy")


#: the value a number takes when what it is read from is not finite (a
#: number JSON can hold, above every limit)
NOT_FINITE = 1e300


def _finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_FINITE


def _worst(values) -> float:
    """The largest of `values`, or NOT_FINITE if any is not finite."""
    values = [float(v) for v in values]
    return max(values) if all(map(math.isfinite, values)) else NOT_FINITE


def healthy(pk: dict, n_active: int, scene: dict, stated: dict) -> bool:
    """One frame's diagnostics within the stated guarantees."""
    g = guarantees([pk], [n_active], scene, stated)
    return passed(g)


def guarantees(packs: list, n_active: list, scene: dict, stated: dict) -> dict:
    """The stated guarantees over every frame's fetched diagnostics, with
    `n_active` the active count each frame should report."""
    rho0 = scene["params"]["rest_density"]
    return {
        "lost": {"value": _worst(abs(n - pk["n_active"])
                                 for pk, n in zip(packs, n_active)),
                 "limit": stated["lost"]},
        "rho_dev": {"value": _worst(abs(pk["mean_rho"] / rho0 - 1.0)
                                    for pk in packs),
                    "limit": stated["rho_dev"]},
        "max_speed": {"value": _worst(pk["max_speed"] for pk in packs),
                      "limit": stated["max_speed"]},
    }


def frame_gaps(ref: Reference, scene: dict, k: int, start: dict, end: dict,
               pack: dict, steps: int) -> dict:
    """The reference's gaps for frame `k` of `steps` steps, from `start` to
    the program's `end` and fetched diagnostics `pack`."""
    p = scene["params"]
    act = end["emit_step"] <= end["step"]
    bad = {n: NOT_FINITE for n in ("x_gap", "v_gap", "rho_gap", "diag_gap")}
    if not all(bool(torch.isfinite(s[f][act]).all())
               for s in (start, end) for f in ("x", "v", "rho")):
        return bad
    if int(end["step"]) != int(start["step"]) + steps:
        return bad
    if k == 0:
        s0 = ref.prime(start) if p["integrator"] == "leapfrog" else start
    else:
        s0 = ref.resume(start)        # nothing the program derived enters
    out = ref.advance(s0, steps)
    dx = (end["x"][act] - out["x"][act]).double()
    dv = (end["v"][act] - out["v"][act]).double()
    drho = (end["rho"][act] - out["rho"][act]).double()
    want = frame_scalars(end, p["mass"])
    diag = max(abs(pack[n] - want[n]) / max(abs(want[n]), 1e-30) for n in DIAG)
    return {
        "x_gap": _finite(float(dx.norm(dim=1).max()) / p["h"]),
        "v_gap": _finite(float(dv.norm(dim=1).max()) / p["sound_speed"]),
        "rho_gap": _finite(float(drho.abs().max()) / p["rest_density"]),
        "diag_gap": _finite(diag),
    }


def reference_checks(frames: list, scene: dict, steps: int, limits: dict,
                     device) -> tuple[dict, int]:
    """(the largest of each gap over `frames`, each beside its limit; the
    number of frames with a gap over its limit).  `frames`: (k, start, end,
    pack) of each checked frame."""
    ref = Reference(scene, device)
    worst: dict = {}
    bad = 0
    for k, start, end, pack in frames:
        gaps = frame_gaps(ref, scene, k, start, end, pack, steps)
        bad += any(v > limits[n] for n, v in gaps.items())
        for n, v in gaps.items():
            worst[n] = max(worst.get(n, 0.0), v)
    return {n: {"value": worst[n], "limit": limits[n]} for n in worst}, bad


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
