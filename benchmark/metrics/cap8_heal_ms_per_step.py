"""Device ms a step of the kernels launched inside the program's
`sph.heal` spans that lie inside its `sph.cap8` dispatches: the exact
re-runs of the blocks that overflow the cap-8 lattice, among them the
heals of the dispatch that makes the policy switch to cap 16.  0 where
no cap-8 block healed; None without `sph.cap8` or the pairing."""

from benchmark.metrics import _spans, _within


def read(obs):
    got = _spans.launched(obs)
    if not len(_spans.spans(obs.trace, _within.CAP8)) or got is None:
        return None
    t, dur = got
    heal = _within.nested(obs.trace, "sph.heal", _within.CAP8)
    return float(dur[_spans.inside(t, heal)].sum()) * 1e-6 / obs.steps
