"""The collectives of the domain decomposition (`decomp.py`), on
`torch.distributed`.

The reference reaches its communication backend through four XLA
collectives inside `shard_map` (`sph_tpu/decomp.py`: `lax.ppermute`,
`all_gather`, `psum`, `axis_index`); here they are these four functions
over the default process group, one process per rank:

  ring_exchange  one face buffer to each ring neighbor (`ppermute`)
  all_gather     rank-ordered concatenation along dim 0 (tiled `all_gather`)
  all_reduce_sum (`psum`)
  rank           (`axis_index`)

The slabs' ring is the whole world in rank order.  Pencils run on an
n1 × n2 grid of the same ranks (`RankGrid`, row-major as `mesh2d` orders
its devices: rank = i1·n2 + i2), with one ring along each axis; the
gathers and sums stay over the whole world, so a gathered state is in the
reference's row-major (i1, i2) order.

The backend follows the device: NCCL for tensors on the card, gloo for the
CPU.  Four ranks on one card run gloo (NCCL will not put two ranks on one
GPU); gloo's transport takes host tensors, so with CUDA tensors each of
these functions copies to the host, communicates, and copies back, while
the compute stays on the card.  Nothing here switches backend or device
when a call fails: the error ends the run.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from sph_tpu_torch.platform import resolve_device


def backend_for(device) -> str:
    """The backend a process group for tensors on `device` takes."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` when given, else `cuda:LOCAL_RANK`
    (as `torchrun` sets it), else `cuda`."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = "cuda" if local is None else f"cuda:{int(local)}"
    return resolve_device(device)


def rank() -> int:
    return dist.get_rank()


def world_size() -> int:
    return dist.get_world_size()


def _host_transport(t: torch.Tensor) -> bool:
    return t.device.type != "cpu" and dist.get_backend() == "gloo"


class RankGrid:
    """The world's ranks as an n1 × n2 grid, row-major: rank r sits at
    divmod(r, n2).  `peers(axis)` are this rank's (left, right) ring
    neighbors along grid axis 0 or 1, wrapping around."""

    def __init__(self, n1: int, n2: int):
        if n1 * n2 != world_size():
            raise ValueError(
                f"a {n1}x{n2} rank grid needs {n1 * n2} ranks, the process "
                f"group has {world_size()}")
        self.n1, self.n2 = n1, n2

    def coords(self) -> tuple[int, int]:
        """This rank's (i1, i2)."""
        return divmod(rank(), self.n2)

    def peers(self, axis: int) -> tuple[int, int]:
        i1, i2 = self.coords()
        if axis == 0:
            return (((i1 - 1) % self.n1) * self.n2 + i2,
                    ((i1 + 1) % self.n1) * self.n2 + i2)
        return (i1 * self.n2 + (i2 - 1) % self.n2,
                i1 * self.n2 + (i2 + 1) % self.n2)


def ring_exchange(to_left: torch.Tensor, to_right: torch.Tensor,
                  peers: tuple[int, int] | None = None):
    """Send `to_left` to the left neighbor and `to_right` to the right one,
    in one batch of point-to-point calls; returns (from_right, from_left):
    what the right neighbor sent left and what the left one sent right.
    `peers` = (left, right) ranks (a ring along one axis of a `RankGrid`);
    None is the world's ring, rank − 1 and rank + 1.  Every rank's buffers
    have one shape.  A ring of one is a local copy."""
    n, r = world_size(), rank()
    left, right = peers if peers is not None else ((r - 1) % n, (r + 1) % n)
    if left == right == r:
        return to_left.clone(), to_right.clone()
    dev = to_left.device
    host = _host_transport(to_left)
    send_l, send_r = to_left.contiguous(), to_right.contiguous()
    if host:
        send_l, send_r = send_l.cpu(), send_r.cpu()
    from_right, from_left = torch.empty_like(send_l), torch.empty_like(send_r)
    # the tags keep the two directions apart where left == right (n = 2)
    ops = [
        dist.P2POp(dist.isend, send_l, left, tag=0),
        dist.P2POp(dist.isend, send_r, right, tag=1),
        dist.P2POp(dist.irecv, from_right, right, tag=0),
        dist.P2POp(dist.irecv, from_left, left, tag=1),
    ]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if host:
        from_right, from_left = from_right.to(dev), from_left.to(dev)
    return from_right, from_left


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (one shape on all ranks) concatenated along dim 0
    in rank order."""
    dev, dtype = t.device, t.dtype
    src = t.contiguous()
    if dtype == torch.bool:
        src = src.view(torch.uint8)
    if _host_transport(src):
        src = src.cpu()
    n = world_size()
    if src.device.type == "cuda":
        out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src)
    else:
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src)
        out = torch.cat(parts, dim=0)
    if dtype == torch.bool:
        out = out.view(torch.bool)
    return out.to(dev)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of `t` (a new tensor on t's device)."""
    dev = t.device
    out = t.clone()
    if _host_transport(out):
        out = out.cpu()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out.to(dev)
