"""P1 in the port (`sph_tpu_torch.probe_vpu_bf16`): the plain version of the
probe kernels against the reference's Pallas kernel (`bench/probe_vpu_bf16.py`,
`make_kernel`) in interpret mode, bitwise, for fp32 and bf16.

The reference probe runs only on a TPU as written; here it is loaded by path
(the top-level `bench.py` shadows the `bench/` directory as a package) and
its module's `pl` is replaced by a namespace whose `pallas_call` runs in
interpret mode, leaving `bench/` untouched.  On U[0,1) inputs the chain stays
finite; on the probe's own inputs (y = x + 2) it squares past fp32's range,
so both sides are all inf there.
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sph_tpu_torch import probe_vpu_bf16 as probe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _reference():
    spec = importlib.util.spec_from_file_location(
        "_probe_vpu_bf16_reference", ROOT / "bench" / "probe_vpu_bf16.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return mod


def _inputs(kind, dtype):
    if kind == "probe":   # the TPU probe's own: one key drawn twice
        key = jax.random.PRNGKey(0)
        x = np.array(jax.random.normal(key, (probe.SUB, probe.LANE)))
        return x, x
    rng = np.random.default_rng(7)
    return (rng.random((probe.SUB, probe.LANE), dtype=np.float32),
            rng.random((probe.SUB, probe.LANE), dtype=np.float32))


@pytest.mark.parametrize("kind", ["uniform", "probe"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_probe_matches_reference_kernel(dtype, kind):
    ref = _reference()
    jdt = jax.numpy.dtype(dtype)
    tdt = getattr(torch, dtype)
    x, y = _inputs(kind, dtype)
    jx = jax.numpy.asarray(x).astype(jdt)
    jy = jax.numpy.asarray(y).astype(jdt) + (2.0 if kind == "probe" else 0.0)
    want = np.asarray(ref.make_kernel(jdt)(jx, jy).astype(jax.numpy.float32))
    tx = torch.from_numpy(x).to(tdt)
    ty = torch.from_numpy(y).to(tdt) + (2.0 if kind == "probe" else 0.0)
    assert np.array_equal(np.asarray(jy.astype(jax.numpy.float32)),
                          ty.float().numpy())
    probe.reset_launches()
    got = probe.probe(tx, ty)
    assert got.dtype == tdt and probe.LAUNCHES == {"probe_f32": 0,
                                                  "probe_bf16": 0}
    got = got.float().numpy()
    if kind == "probe":
        assert np.isinf(want).all() and np.isinf(got).all()
    else:
        assert np.isfinite(want).all()
    assert np.array_equal(got, want)


def test_probe_inputs_are_the_reference_probes():
    """`probe_inputs` draws x ~ N(0, 1) and y = x + 2 in the dtype, as the
    TPU probe's `bench` does (torch's generator, not JAX's: the values
    differ, the construction does not), and they overflow the chain."""
    x, y = probe.probe_inputs(torch.bfloat16, "cpu")
    assert x.shape == (probe.SUB, probe.LANE) and x.dtype == torch.bfloat16
    assert torch.equal(y, x + 2.0)
    assert abs(float(x.float().mean())) < 0.01
    assert abs(float(x.float().std()) - 1.0) < 0.01
    assert torch.isinf(probe.chain_plain(x[:4], y[:4])).all()


def test_probe_rejects_what_the_kernels_do_not_take():
    x = torch.zeros((4, 6))
    with pytest.raises(TypeError):
        probe.probe(x.double(), x.double())
    with pytest.raises(ValueError):
        probe.probe(x, x[:2])
    with pytest.raises(ValueError):
        probe.probe(x.bfloat16().reshape(-1)[1:], x.bfloat16().reshape(-1)[1:])
    assert probe.ops_per_call() == 64 * 4 * 512 * 1024
    ms, by = probe.bound_ms(torch.float32, 1980.0, 132)
    assert by == "operations"
    assert ms == pytest.approx(64 * 5 * 512 * 1024 / (128 * 132 * 1.98e9) * 1e3)
    assert probe.bound_ms(torch.bfloat16, 1980.0, 132)[0] == pytest.approx(
        ms / 2)
