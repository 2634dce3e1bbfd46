"""The port's decomposed soak and cap-evidence tools
(`sph_tpu_torch.soak_spatial`, `measure_spill`, `bench_sweep`) against
the reference's scripts in `bench/`, and the rules of all six long-run
entry points, on the CPU: the method and tolerances of
tests/test_torch_soak.py, whose helpers this file uses.
"""

import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu.decomp
from sph_tpu_torch import (
    bench_sweep,
    decomp,
    make_settled_state,
    measure_spill,
    soak_1m,
    soak_emitters,
    soak_spatial,
)
from test_torch_soak import (  # noqa: F401 — bench_untouched is autouse
    MODULES,
    _agree_v3,
    _calm,
    _Counters,
    _jet,
    _port_scene,
    _run_script,
    _same_lines,
    _script,
    _snapshot,
    bench_untouched,
)

torch.set_num_threads(1)


RECOVER_AT = 200


def test_soak_spatial_one_rank_matches_reference(monkeypatch, capsys):
    """One gloo rank against `mesh1d(1)`, through an elastic recovery:
    both advances raise SpatialCapOverflow once, at the dispatch that
    starts at RECOVER_AT (one rank's own buffers never overflow: its spec
    holds every particle), so both gather, re-spec, re-shard and run the
    dispatch again.  The gathered final states hold the same particles in
    the same slots and x within 1e-4 of the position scale, the repo's
    tolerance between decomposed runs (ROADMAP Queue 3 item 3;
    tests/test_torch_decomp_fast.py): over the dam break's 500 steps the
    two trajectories part by ~6e-6 of scale, more than rtol 1e-5 allows
    near the wall."""
    ref_scene = _calm()
    mod = _script("soak_spatial")
    spy = _Counters(monkeypatch)
    for pkg in (sph_tpu.decomp, decomp):
        real, made = pkg.make_audited_spatial_advance, []

        def faulty(*a, _real=real, _pkg=pkg, _made=made, **kw):
            adv = _real(*a, **kw)
            _made.append(adv)
            first = len(_made) == 1

            def advance(loc):
                if first and int(loc.step) == RECOVER_AT:
                    raise _pkg.SpatialCapOverflow("forced")
                return adv(loc)

            advance.__dict__ = adv.__dict__   # its counters and mode
            return advance

        monkeypatch.setattr(pkg, "make_audited_spatial_advance", faulty)
    gathered = []
    real_gather = sph_tpu.decomp.spatial_gather_state
    monkeypatch.setattr(mod.decomp, "spatial_gather_state",
                        lambda loc: gathered.append(real_gather(loc))
                        or gathered[-1])
    ref_lines = _run_script(mod, [500, 1], monkeypatch, capsys, ref_scene)
    ours = soak_spatial.soak(500, 1, "cpu", scene=_port_scene(ref_scene))
    lines = capsys.readouterr().out.splitlines()
    _same_lines(lines, ref_lines)
    assert not torch.distributed.is_initialized()
    assert [r["step"] for r in ours["recoveries"]] == [RECOVER_AT]
    assert any(f"elastic recovery at step {RECOVER_AT}: forced" in ln
               for ln in lines)
    assert ours["probes"][-1]["n_act"] == ours["n"] == ours["n_final"]
    assert ours["rebuilds"] == spy.rebuilds
    assert lines[-1].startswith("SPATIAL SOAK RESULT: 400 timed steps")
    ref, got = gathered[-1], ours["state"]
    for f in ("emit_step", "kind"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(ref, f))), f
    x_ref = np.asarray(ref.x)
    assert (np.abs(got.x.numpy() - x_ref).max()
            < 1e-4 * np.abs(x_ref).max())


def test_soak_spatial_needs_its_ranks():
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        soak_spatial.soak(200, 2, "cpu", scene=_port_scene(_calm()))
    assert soak_spatial.main(["200", "2", "--device", "cpu"]) == 2


# ---------------------------------------------------------------------------
# the cap-evidence tools
# ---------------------------------------------------------------------------


def test_measure_spill_matches_reference(monkeypatch, capsys):
    """At cap 2 the tank spills; the counts are integers: equal."""
    ref_scene = _jet()
    mod = _script("measure_spill")
    ref_lines = _run_script(mod, ["tank", 300, 2], monkeypatch, capsys,
                            ref_scene)
    ours = measure_spill.measure("tank", 300, 2, "cpu",
                                 scene=_port_scene(ref_scene))
    lines = capsys.readouterr().out.splitlines()
    assert lines == ref_lines
    assert ours["worst_spilled"] > 0 and len(ours["rows"]) == 3
    assert lines[-1] == (f"WORST over 300 steps: spilled(cap=2)="
                         f"{ours['worst_spilled']} max_occ="
                         f"{ours['worst_max_occ']} spilled(cap=4)="
                         f"{ours['worst_spilled2']}")


def test_bench_sweep_matches_reference(monkeypatch, capsys):
    ref_scene = _calm()
    mod = _script("bench_sweep")
    states = []      # the reference's state after each dispatch
    real = mod.make_advance

    def recorded(*a, **kw):
        adv = real(*a, **kw)
        return lambda st: states.append(adv(st)) or states[-1]

    monkeypatch.setattr(mod, "make_advance", recorded)
    ref_lines = _run_script(mod, ["tank", 8], monkeypatch, capsys, ref_scene)
    rows = bench_sweep.sweep("tank", 8, "cpu", scene=_port_scene(ref_scene))
    lines = capsys.readouterr().out.splitlines()
    _same_lines(lines, ref_lines)
    assert [r["cap"] for r in rows] == [8, 16, 32]
    assert not any("fail" in r for r in rows) and "FAIL" not in "".join(lines)
    assert len(states) == 6
    for r, st in zip(rows, states[1::2]):
        _agree_v3(st, r["state"], f"cap {r['cap']}")
        assert r["n"] == int(st.n_active()) and int(st.step) == 16


def test_bench_sweep_failing_cap_is_a_fail_line(monkeypatch, capsys):
    monkeypatch.setattr(bench_sweep, "CAPS", (48,))
    rows = bench_sweep.sweep("tank", 4, "cpu", scene=_port_scene(_calm()))
    out = capsys.readouterr().out
    assert rows[0]["cap"] == 48 and "fail" in rows[0]
    assert out.startswith("cap= 48  FAIL ValueError")


# ---------------------------------------------------------------------------
# the entry points' rules
# ---------------------------------------------------------------------------


# each entry point's function with its defaults: the card
FUNCTIONS = {
    "make_settled_state": lambda: make_settled_state.regen("splash3d_1m"),
    "soak_1m": soak_1m.soak,
    "soak_emitters": lambda: soak_emitters.soak("vortex2d"),
    "soak_spatial": soak_spatial.soak,
    "measure_spill": measure_spill.measure,
    "bench_sweep": bench_sweep.sweep,
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_no_card_is_one_line(name, monkeypatch, capsys):
    """Without a card the command exits 1 with one line, and its function
    raises: neither carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert MODULES[name].main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and len(out.err.strip().splitlines()) == 1
    assert "no CUDA device" in out.err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FUNCTIONS[name]()


def test_zz_nothing_written_under_bench(bench_untouched):
    """Every test above wrote what it wrote to its tmp directory."""
    assert _snapshot() == bench_untouched
