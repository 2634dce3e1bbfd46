"""The share of the traced pass in which no device operation ran: 1 - the
device's busy time over the pass's length, both from the one profiled
pass (`device.busy_s` and `device.window_s` of the result line)."""


def read(obs):
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
