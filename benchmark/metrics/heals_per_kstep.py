"""Resident blocks healed (re-run exactly on the per-step path) a thousand
steps: the audited advance's `.healed` over the traced pass."""


def read(obs):
    n = obs.counters["healed"]
    return None if n is None else 1e3 * n / obs.steps
