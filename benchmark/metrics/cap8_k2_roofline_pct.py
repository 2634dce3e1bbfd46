"""K2's share of its roofline on the cap-8 lattice: the slot force kernel
(`staged_kernel<DIM, T, true>`) launched inside the cap-8 policy's
`sph.cap8` dispatches, each launch bounded on its frame's pairs as
`k2_roofline_pct` bounds it."""

from benchmark.metrics import _roofline as rl
from benchmark.metrics import _within


def read(obs):
    return _within.cap8_roofline_pct(
        obs, rl.K2,
        lambda d, fp: rl.force_ops(d, fp["near"], fp["particles"]),
        lambda d, fp: rl.force_bytes(d, fp["particles"]))
