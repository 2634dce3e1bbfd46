"""Device selection for the port's entry points.

`None` means the CUDA card.  The port never carries on silently on the
CPU: with no card, only an explicit `device="cpu"` (what the tests pass)
runs, and then every slot kernel takes its plain PyTorch version.
"""

from __future__ import annotations

import argparse
import functools
import re

import torch


@functools.lru_cache(maxsize=None)
def device_const(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor (grid origin, gravity, walls), made on
    `device` at its first use and reused after.  A copy from host memory
    blocks the host until the device has caught up, so a step makes none of
    its constants afresh.  Callers never write into the result."""
    return torch.tensor(values, dtype=dtype, device=device)


def resolve_device(device=None) -> torch.device:
    """`None` → `cuda`; raises when a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sph_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions of the kernels on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"sph_tpu_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def device_arg(text: str) -> str:
    """argparse type of the command lines' `--device`: cuda, cuda:K or cpu."""
    if re.fullmatch(r"cpu|cuda(:\d+)?", text):
        return text
    raise argparse.ArgumentTypeError(
        f"invalid device {text!r} (cuda, cuda:K or cpu)")


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    """The `--device` flag of the port's entry points."""
    ap.add_argument("--device", default="cuda", type=device_arg,
                    help="cuda (default; exits when there is no card), "
                         "cuda:K, or cpu (the kernels' plain versions)")


def entry_device(text: str):
    """An entry point's device from its `--device`, or None after one line
    on stderr saying why there is none (the caller then exits 1)."""
    import sys

    try:
        return resolve_device(text)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return None
