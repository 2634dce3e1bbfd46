"""The check that decides `correct` fails a broken program.

Each test drives the rest of a run (set-up, the window, the reference's
check) on the CPU at the small cell's size, under the limits of the
benchmark's own cells, skipping only the harness's look for a card, with
a fault planted under the timed path: an advance that returns its state
unchanged, one that leaves half the particles out, one that alters an
answer where it is produced, one that hands the next frame a wrong
acceleration, diagnostics altered where they are made, and
the control, the program's own bf16 feature path.  The exchange between
chips is not a fault these cells can have: each runs on one card."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, spec
from benchmark.tests.small import small_cell

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _run(cell, seed=20260101, precision=None):
    if precision is not None:
        cell.config["scene"]["params"]["precision"] = precision
    return harness.run_cell(cell, seed, 0.0, False, torch.device("cpu"), 0.0)


def _cell(name: str):
    c = spec.load_cell(name)
    return small_cell(c.config["name"], steps=16, spf=8, draw=((1, 1),),
                      limits=c.workload["limits"])


def _plant(monkeypatch, fault):
    from sph_tpu_torch import step

    make = step.make_audited_advance

    def broken(*a, **kw):
        adv = make(*a, **kw)

        def advance(st):
            return fault(st, adv(st))
        return advance
    monkeypatch.setattr(step, "make_audited_advance", broken)


def _unchanged(before, after):
    return before


def _half_left_out(before, after):
    x, v = after.x.clone(), after.v.clone()
    x[::2], v[::2] = before.x[::2], before.v[::2]
    return after.replace(x=x, v=v)


def _answer_altered(before, after):
    x = after.x.clone()
    x[0, 0] += 0.25 * 16.0        # one fluid particle moved by h/4
    return after.replace(x=x)


def _acc_altered(before, after):
    # the acceleration a frame hands to the next one's first half-kick,
    # off by a factor of 10: the positions and velocities it ends with
    # are right, so only a reference that works the acceleration out
    # again sees the next frame go wrong
    return after.replace(acc=after.acc * 10.0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(_cell(name))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] == 2


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _answer_altered,
                                   _acc_altered])
@pytest.mark.parametrize("name", CELLS)
def test_broken_advance_is_not_correct(monkeypatch, name, fault):
    _plant(monkeypatch, fault)
    r = _run(_cell(name))
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_altered_diagnostics_are_not_correct(monkeypatch, name):
    from sph_tpu_torch import diagnostics

    pack = diagnostics.scalar_pack

    def off(state, params):
        out = pack(state, params).clone()
        out[2] *= 1.01            # mean rho
        return out
    monkeypatch.setattr(diagnostics, "scalar_pack", off)
    r = _run(_cell(name))
    assert not r["correct"]
    assert r["checks"]["diag_gap"]["value"] > r["checks"]["diag_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_control_bf16_is_not_correct(name):
    r = _run(_cell(name), precision="bf16")
    assert not r["correct"], r["checks"]


@pytest.mark.gpu
def test_sound_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = _cell(CELLS[0])
    r = harness.run_cell(cell, 77, 0.0, True, torch.device("cuda", 0), 0.0)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
