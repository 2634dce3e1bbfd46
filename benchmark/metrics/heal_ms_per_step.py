"""Device ms a step of the kernels launched inside the program's
`sph.heal` spans: a violating resident block's exact re-run on the
per-step path, its fresh build and its re-fetched `need`."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.device_ms_per_step(obs, "sph.heal")
