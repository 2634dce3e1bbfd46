"""Device ms a step of the kernels launched inside the program's
`sph.build_addr`, `sph.scatter` and `sph.gather` spans: the slot
addressing (`pallas_step.build_addr`), the feature scatter into slots and
the gathers back to particles, wherever they run (a rebuild's addressing
counts here and in `rebuild_ms_per_step` too)."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.device_ms_per_step(obs, "sph.build_addr", "sph.scatter",
                                     "sph.gather")
