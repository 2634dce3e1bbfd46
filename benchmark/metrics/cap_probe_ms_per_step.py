"""Host ms a step inside the cap-8 policy's probe (`sph.cap_probe`): up to
three bincounts of the state on candidate cap-8 lattices, one host fetch
each (`step.cap8_skin`), and the cap-8 advance it then makes."""

from benchmark.metrics import _spans


def read(obs):
    return _spans.host_ms_per_step(obs, "sph.cap_probe")
