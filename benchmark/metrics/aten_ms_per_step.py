"""Device ms a step of every kernel that is not one of the program's own
(`sph_tpu_torch/csrc/*.cu`): PyTorch's kernels, which do the slot
addressing, scatter and gathers, the policy's minority repair (its
`torch.cumsum` scan), the diagnostics and the rest.  Kernel names do not
tell these apart (the addressing scans too); the program's
`record_function` ranges would."""

import re


def read(obs):
    own = re.compile(r"\b(" + "|".join(sorted(obs.program_kernels)) + r")\b")
    ns = sum(d for name, _, d in obs.trace.kernels if not own.search(name))
    return ns * 1e-6 / obs.steps
