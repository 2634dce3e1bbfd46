"""sph_tpu_torch — the SPH engine of `sph_tpu`, ported to PyTorch and
hand-written CUDA for an NVIDIA H100.

Names and structure follow `sph_tpu`, so each module has a counterpart
there.  The package imports neither JAX nor `sph_tpu`.  Entry points take
`device=None`, meaning the CUDA card, and raise when there is none unless
`device="cpu"` is passed; on CPU tensors the slot kernels run their plain
PyTorch versions.

This slice covers the per-step path (`method="naive"` and `"pallas"` with
`sort_every=1`); see ROADMAP.md for what follows.
"""

from sph_tpu_torch.params import (
    Block,
    Emitter,
    ForceField,
    Scene,
    SimParams,
    calibrate,
    preset,
    preset_names,
    scene_from_json,
    scene_to_json,
)
from sph_tpu_torch.state import State, init
from sph_tpu_torch.step import make_advance, make_step, prime, run

__all__ = [
    "SimParams",
    "Scene",
    "Block",
    "Emitter",
    "ForceField",
    "calibrate",
    "preset",
    "preset_names",
    "scene_from_json",
    "scene_to_json",
    "State",
    "init",
    "make_step",
    "make_advance",
    "prime",
    "run",
]

__version__ = "0.1.0"
