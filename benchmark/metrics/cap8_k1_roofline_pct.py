"""K1's share of its roofline on the cap-8 lattice: the slot density
kernel (`staged_kernel<DIM, T, false>`) launched inside the cap-8
policy's `sph.cap8` dispatches, each launch bounded on its frame's pairs
as `k1_roofline_pct` bounds it."""

from benchmark.metrics import _roofline as rl
from benchmark.metrics import _within


def read(obs):
    return _within.cap8_roofline_pct(
        obs, rl.K1, lambda d, fp: rl.density_ops(d, fp["near"]),
        lambda d, fp: rl.density_bytes(d, fp["particles"]))
