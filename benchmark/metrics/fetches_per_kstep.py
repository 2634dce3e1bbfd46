"""Host fetches of the program's driver a thousand steps
(`sph_tpu_torch.step.FETCHES`, over the traced pass; the frame's own
diagnostics fetch is the harness's and is not counted)."""


def read(obs):
    return 1e3 * obs.counters["fetches"] / obs.steps
