"""What ran inside the cap-8 policy's spans: `sph.cap8`, each dispatch the
program runs on the cap-8 lattice (`make_audited_advance(...,
adaptive_cap=True)`), and `sph.cap_probe`, its probe of that lattice.

The kernels are paired with their launch calls by `_spans.launched`.  A
trace without these spans (another path, or a program that does not mark
them) gives None.
"""

from __future__ import annotations

from dataclasses import replace
from types import SimpleNamespace

from benchmark.metrics import _roofline as rl
from benchmark.metrics import _spans

CAP8, PROBE = "sph.cap8", "sph.cap_probe"


def nested(tr, name: str, outer: str):
    """The spans named `name` (merged) that start inside a span named
    `outer`."""
    iv = _spans.spans(tr, name)
    return iv[_spans.inside(iv[:, 0], _spans.spans(tr, outer))]


def cap8_roofline_pct(obs, pattern, ops, nbytes) -> float | None:
    """`_roofline.kernel_roofline_pct` over the launches made on the cap-8
    lattice: inside `sph.cap8` and outside its `sph.heal` spans, whose
    exact re-runs launch K1/K2 on the per-step path's cap-16 grid.  None
    without such a span or such a launch, or unless every kernel of the
    pass is paired with its launch call."""
    tr = obs.trace
    cap8 = _spans.spans(tr, CAP8)
    got = _spans.launched(obs)
    if not len(cap8) or got is None or len(got[0]) != len(tr.kernels):
        return None
    t = got[0]
    sel = _spans.inside(t, cap8) & ~_spans.inside(t, _spans.spans(tr,
                                                                 "sph.heal"))
    kern = sorted(tr.kernels, key=lambda k: k[1])
    lattice = SimpleNamespace(**{**vars(obs), "trace": replace(
        tr, kernels=[k for k, s in zip(kern, sel) if s])})
    return rl.kernel_roofline_pct(lattice, pattern, ops, nbytes)
