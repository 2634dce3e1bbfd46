"""K5 (staging transpose): the wrapper around the CUDA kernel in
`csrc/stage_kernels.cu`, its plain PyTorch version, and its launch count.

K5 replaces `_stage_transpose_kernel` (sph_tpu/pallas_step.py:555, driven
by `_stage_to_feat` :559).  `scatter_slots(staged=True)` scatters each
particle's feature row into a feature-minor staging array
`stag[c_rows·lanes, FEAT]`, where a particle's features are contiguous, and
K5 turns it into the kernels' layout, per compacted row:

    feat[r, c, l] = stag[r·lanes + l, c]

for every row, so `feat` is the whole `[c_rows, FEAT, lanes]` array.  It
moves 32-bit words with no arithmetic: the kernel, its plain version and the
direct scatter give the same bits.

A wrapper given CUDA tensors launches its kernel (building it at first use)
or raises; given CPU tensors it runs the plain version.  `LAUNCHES` counts
kernel launches only.  What bounds the kernel on the card, and its design,
is noted in the CUDA source; PERF.md holds its time.
"""

from __future__ import annotations

import torch

from sph_tpu_torch import _build
from sph_tpu_torch.slot_kernels import FEAT, LANE, _raise_on, _stream

#: kernel launches since the last `reset_launches()`
LAUNCHES = {"stage_transpose": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stage_transpose_plain(stag: torch.Tensor, c_rows: int, lanes: int):
    """Plain version of K5: [c_rows·lanes, FEAT] → [c_rows, FEAT, lanes]."""
    return stag.reshape(c_rows, lanes, FEAT).transpose(1, 2).contiguous()


def stage_transpose(stag: torch.Tensor, c_rows: int, lanes: int):
    """K5 → feat [c_rows, FEAT, lanes] from the staging array `stag`
    [c_rows·lanes, FEAT] (any 32-bit dtype on the card)."""
    if stag.shape != (c_rows * lanes, FEAT):
        raise ValueError(
            f"stag has shape {tuple(stag.shape)}, want ({c_rows * lanes}, {FEAT})"
        )
    if not stag.is_contiguous():
        raise ValueError("stag must be contiguous")
    if stag.device.type == "cpu":
        return stage_transpose_plain(stag, c_rows, lanes)
    if stag.element_size() != 4:
        raise TypeError(f"K5 moves 32-bit words, got {stag.dtype}")
    if lanes % LANE or c_rows > 65535 or stag.data_ptr() % 16:
        raise ValueError(
            f"K5 takes lanes in whole {LANE}-lane tiles, at most 65535 rows "
            f"and a 16-byte aligned input; got lanes {lanes}, c_rows {c_rows}"
        )
    lib = _build.library("stage_kernels")
    feat = torch.empty((c_rows, FEAT, lanes), dtype=stag.dtype,
                       device=stag.device)
    rc = lib.stage_transpose(stag.data_ptr(), feat.data_ptr(), c_rows, lanes,
                             stag.device.index or 0, _stream(stag.device))
    _raise_on(rc, "stage_transpose")
    LAUNCHES["stage_transpose"] += 1
    return feat
