"""Device ms a step of the kernels launched inside the program's
`sph.repair` spans: the resident advance's minority repair attempts (the
plan, its feasibility fetch and, when that says yes, the re-homing); a
rebuild after a failed attempt is not in it."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.device_ms_per_step(obs, "sph.repair")
