"""Slot rebuilds of the resident block a thousand steps: the audited
advance's `.rebuilds` over the traced pass."""


def read(obs):
    n = obs.counters["rebuilds"]
    return None if n is None else 1e3 * n / obs.steps
