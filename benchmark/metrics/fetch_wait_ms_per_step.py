"""Host ms a step inside the program's `sph.fetch` spans: the driver's
round trips for its decisions, each a wait for the device to reach the
value and its copy to the host."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.host_ms_per_step(obs, "sph.fetch")
