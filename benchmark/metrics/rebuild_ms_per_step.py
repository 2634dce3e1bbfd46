"""Device ms a step of the kernels launched inside the program's
`sph.rebuild` spans: the resident advance's builds outside a heal (a
dispatch's entry and each policy rebuild: materialize, `build_addr`,
scatter)."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.device_ms_per_step(obs, "sph.rebuild")
