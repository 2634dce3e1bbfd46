"""Device idle ms a step while a resident block launched its steps: the
gaps between device activity in the traced pass whose midpoint lies
inside one of the program's `sph.block` spans."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.idle_ms_per_step(obs, "sph.block")
