"""Checkpoint and resume (port of `save_checkpoint` / `load_checkpoint` of
`sph_tpu/diagnostics.py`).

One `.npz` holds the eight `State` fields and the scene as JSON bytes under
`__scene_json__`.  The format is the reference's, so a file written by
either package is read by the other and a resume is bitwise.  The rest of
the reference's diagnostics (scalar pack, watchdog, state validation) is not
ported yet (ROADMAP.md Queue 1 item 11).
"""

from __future__ import annotations

import numpy as np

from sph_tpu_torch.params import Scene, scene_from_json, scene_to_json
from sph_tpu_torch.state import State

_SCENE_KEY = "__scene_json__"


def save_checkpoint(path: str, state: State, scene: Scene) -> None:
    """State + scene config → one .npz (the state is fetched to the host)."""
    arrays = state.to_numpy()
    arrays[_SCENE_KEY] = np.frombuffer(
        scene_to_json(scene).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, device=None) -> tuple[State, Scene]:
    """→ (state on `device` (None = the card), scene)."""
    with np.load(path) as z:
        scene = scene_from_json(bytes(z[_SCENE_KEY]).decode())
        arrays = {k: z[k] for k in z.files if k != _SCENE_KEY}
    return State.from_numpy(arrays, device), scene
