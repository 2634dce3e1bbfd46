"""The program's profiler spans (`platform.span`, names `sph.*`) on the
resident auto-rebuild advance: each span counted against the counter of
the same event, their nesting, the state unchanged by the profiler, and
the spans' no-op when no profiler records.

The scene is a calm dam hit by a fast dart on the CPU (2-D, 32-step
dispatches of 4-step blocks, `repair_k` 2): its blocks heal, repair,
fail to repair and rebuild.  It has no emitters, so every host fetch goes
through `step._fetch`."""

import pytest
import torch

import sph_tpu_torch as port
from sph_tpu_torch import platform
from sph_tpu_torch import step as port_step

torch.set_num_threads(1)

CPU = dict(device="cpu")
FIELDS = ("x", "v", "acc", "rho", "p", "kind", "emit_step", "step")


def _dart_scene():
    p = port.SimParams()
    lo = (p.wall_eps + 4, p.wall_eps + 4)
    return port.calibrate(port.Scene(
        params=p, lo=(0.0, 0.0), hi=(400.0, 400.0),
        blocks=(port.Block(lo=lo, hi=(lo[0] + 60, lo[1] + 100)),
                port.Block(lo=(60.0, 30.0), hi=(90.0, 60.0),
                           velocity=(-450.0, 0.0))),
        seed=99))


def _run(profiled: bool):
    """Two dispatches of the audited resident advance; → (state, advance,
    FETCHES, the profiler's `sph.*` events as (name, start, end) or
    None)."""
    scene = _dart_scene()
    adv = port.make_audited_advance(scene, "pallas", 32, sort_every=4,
                                    slot_resident=True, repair_k=2, **CPU)
    st = port.init(scene, **CPU)
    if scene.params.integrator == "leapfrog":
        st = port.prime(scene, st, "pallas", **CPU)
    port_step.reset_fetches()

    def go(st):
        for _ in range(2):
            st = adv(st)
        return st

    if not profiled:
        return go(st), adv, dict(port_step.FETCHES), None
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        st = go(st)
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("sph.")]
    return st, adv, dict(port_step.FETCHES), spans


@pytest.fixture(scope="module")
def runs():
    return _run(True), _run(False)


def _count(spans, name):
    return sum(1 for n, _, _ in spans if n == name)


def _inside(ev, spans, names):
    """Whether the event `ev` lies inside a span of one of `names`."""
    _, a, b = ev
    return any(n in names and s <= a and b <= e for n, s, e in spans)


def test_spans_agree_with_the_counters(runs):
    (_, adv, fetches, spans), _ = runs
    assert adv.healed > 0 and adv.rebuilds > adv.healed + 2
    assert 0 < adv.repaired < _count(spans, "sph.repair")
    assert _count(spans, "sph.heal") == adv.healed
    assert _count(spans, "sph.rebuild") == adv.rebuilds - adv.healed
    assert _count(spans, "sph.fetch") == fetches["fetches"]
    assert _count(spans, "sph.block") == fetches["blocks"] == 16
    for name in ("sph.build_addr", "sph.scatter", "sph.gather"):
        assert _count(spans, name) > 0, name


def test_spans_nest_at_their_layers(runs):
    (_, _, _, spans), _ = runs
    for ev in spans:
        if ev[0] == "sph.block":
            assert not _inside(ev, spans, {"sph.repair"})
        if ev[0] in ("sph.build_addr", "sph.scatter"):
            assert _inside(ev, spans, {"sph.rebuild", "sph.heal"}), ev
    fetch_in_repair = [ev for ev in spans if ev[0] == "sph.fetch"
                       and _inside(ev, spans, {"sph.repair"})]
    assert len(fetch_in_repair) == _count(spans, "sph.repair")


def test_the_profiler_leaves_the_state_as_it_was(runs):
    (st_p, adv_p, f_p, _), (st, adv, f, _) = runs
    for name in FIELDS:
        a, b = getattr(st_p, name), getattr(st, name)
        if a.is_floating_point():      # bit for bit: -0 and +0 differ
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name
    assert (adv_p.healed, adv_p.rebuilds, adv_p.repaired, f_p) == (
        adv.healed, adv.rebuilds, adv.repaired, f)


def test_span_is_one_shared_no_op_when_no_profiler_records(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a RecordFunction was made for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = platform.span("sph.block"), platform.span("sph.fetch")
    assert a is b
    with a:
        with b:
            pass
