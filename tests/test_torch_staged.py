"""K5 and `scatter_slots(staged=True)` in the port against the reference's
(`sph_tpu.pallas_step.scatter_slots(staged=True)`, whose K5
`_stage_transpose_kernel` runs in Pallas interpret mode here) and against
the port's direct scatter: bitwise, for 6 and 7 columns, on the slot and
the packed grids, with particles that have no slot (inactive, past the cell
cap, past the packed row capacity).  K5 itself runs on the card only
(tests/test_torch_gpu.py); on the CPU its wrapper takes the plain version
and counts no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_tpu_torch as port
from helpers import random_cloud
from sph_tpu import neighbors as jnb
from sph_tpu import pallas_step as jps
from sph_tpu.params import Scene as RefScene
from sph_tpu.params import SimParams as RefParams
from sph_tpu_torch import neighbors as tnb
from sph_tpu_torch import pallas_step as tps
from sph_tpu_torch import stage_kernels

torch.set_num_threads(1)


def _cloud(dim, packed, ncols, seed=71):
    """(reference sg, addr), (port sg, addr), rows [n, ncols]: a cloud with
    a dense clump (cap overflow / row overflow), inactive particles and a
    few outside the box."""
    n = 600
    x, _ = random_cloud(n, dim, -10.0, 130.0, seed=seed)
    x = x[:, :dim]
    x[:200] = 40.0 + (x[:200] - 40.0) * 0.02        # one overfull cell
    active = np.ones(n, bool)
    active[-50:] = False
    rng = np.random.default_rng(seed)
    rows = rng.uniform(-5.0, 5.0, (n, ncols)).astype(np.float32)
    rows[:, :dim] = x
    p = RefParams(dim=dim, gravity=(0.0,) * dim)
    ref_scene = RefScene(params=p, lo=(0.0,) * dim, hi=(120.0,) * dim)
    scene = port.Scene(params=port.SimParams(dim=dim, gravity=(0.0,) * dim),
                       lo=(0.0,) * dim, hi=(120.0,) * dim)
    rg = jnb.GridSpec.for_scene(ref_scene, cap=16)
    tg = tnb.GridSpec.for_scene(scene, cap=16)
    rsg = jps.packed_grid(rg, 128) if packed else jps.slot_grid(rg)
    tsg = tps.packed_grid(tg, 128) if packed else tps.slot_grid(tg)
    raddr = jps.build_addr(jnp.asarray(x), jnp.asarray(active), rg, rsg)
    taddr = tps.build_addr(torch.from_numpy(x), torch.from_numpy(active),
                           tg, tsg)
    return (rsg, raddr), (tsg, taddr), rows


@pytest.mark.parametrize("ncols", [6, 7])
@pytest.mark.parametrize("packed", [False, True], ids=["slot", "packed"])
@pytest.mark.parametrize("dim", [2, 3])
def test_staged_scatter_matches_reference_and_direct(dim, packed, ncols):
    (rsg, raddr), (tsg, taddr), rows = _cloud(dim, packed, ncols)
    assert int(taddr.overflow) > 0 and int(raddr.overflow) == int(taddr.overflow)
    assert not bool(taddr.ok().all())
    stage_kernels.reset_launches()
    ours = tps.scatter_slots(taddr, torch.from_numpy(rows), tsg, staged=True)
    direct = tps.scatter_slots(taddr, torch.from_numpy(rows), tsg)
    ref = np.asarray(jps.scatter_slots(raddr, jnp.asarray(rows), rsg,
                                       staged=True))
    assert ours.shape == direct.shape == ref.shape == (
        tsg.c_rows, 8, tsg.lanes)
    assert ours.dtype == torch.float32 and ours.is_contiguous()
    assert np.array_equal(ours.numpy(), ref)
    assert torch.equal(ours, direct)
    # every particle with a slot is where the direct scatter puts it, and
    # the rest of the array is the empty-slot row
    real = ours[:, 0] < 1e17
    assert int(real.sum()) == int(taddr.ok().sum())
    empty = ours.permute(0, 2, 1)[~real]
    assert torch.equal(empty, torch.tensor(
        [1e18, 1e18, 1e18, 0, 0, 0, 0, 0], dtype=torch.float32).expand_as(empty))
    assert stage_kernels.LAUNCHES == {"stage_transpose": 0}


def test_stage_transpose_plain_version():
    c_rows, lanes = 3, 256
    stag = torch.arange(c_rows * lanes * 8, dtype=torch.float32).reshape(-1, 8)
    out = stage_kernels.stage_transpose(stag, c_rows, lanes)
    want = np.asarray(stag).reshape(c_rows, lanes, 8).transpose(0, 2, 1)
    assert np.array_equal(out.numpy(), want)
    assert out.is_contiguous()
    assert torch.equal(out, stage_kernels.stage_transpose_plain(
        stag, c_rows, lanes))
    with pytest.raises(ValueError):
        stage_kernels.stage_transpose(stag[:-1], c_rows, lanes)
    with pytest.raises(ValueError):
        stage_kernels.stage_transpose(stag.T.contiguous().T, c_rows, lanes)
