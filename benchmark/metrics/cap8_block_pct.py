"""The share of the traced pass's resident blocks (`sph.block` spans) run
on the cap-8 lattice, inside the cap-8 policy's `sph.cap8` dispatches, in
%.  None where the pass holds neither `sph.cap8` nor `sph.cap_probe`, so
that it did not run the cap-8 policy; 0 where the probe found no cap-8
lattice that fits."""

from benchmark.metrics import _spans, _within


def read(obs):
    tr = obs.trace
    if not len(_spans.spans(tr, _within.CAP8, _within.PROBE)):
        return None
    blocks = len(_spans.spans(tr, "sph.block"))
    if not blocks:
        return None
    return 100.0 * len(_within.nested(tr, "sph.block", _within.CAP8)) / blocks
