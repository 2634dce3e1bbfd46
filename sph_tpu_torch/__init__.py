"""sph_tpu_torch — the SPH engine of `sph_tpu`, ported to PyTorch and
hand-written CUDA for an NVIDIA H100.

Names and structure follow `sph_tpu`, so each module has a counterpart
there.  The package imports neither JAX nor `sph_tpu`.  Entry points take
`device=None`, meaning the CUDA card, and raise when there is none unless
`device="cpu"` is passed; on CPU tensors the slot kernels run their plain
PyTorch versions.

Ported so far: `method="naive"`, and `method="pallas"` on the slot layout
or on packed rows (`packed_rows=True`), per step, with Verlet-skin address
reuse (`sort_every > 1`), and slot-resident with auto-rebuild, heal, repair,
demotion and the packed auto policy — the production default,
`run(scene, n, method="pallas", sort_every=4, slot_resident=True)`;
`scatter_slots(staged=True)`; checkpoints and `spawn`.  See ROADMAP.md for
what follows.
"""

from sph_tpu_torch.diagnostics import load_checkpoint, save_checkpoint

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
from sph_tpu_torch.state import State, init, spawn
from sph_tpu_torch.step import (
    default_repair_k,
    default_skin,
    make_advance,
    make_audited_advance,
    make_step,
    packed_fits,
    prime,
    run,
)

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
    "spawn",
    "save_checkpoint",
    "load_checkpoint",
    "make_step",
    "make_advance",
    "make_audited_advance",
    "default_skin",
    "default_repair_k",
    "packed_fits",
    "prime",
    "run",
]

__version__ = "0.1.0"
