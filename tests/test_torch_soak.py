"""The port's long-run entry points (`sph_tpu_torch.make_settled_state`,
`soak_1m`, `soak_emitters`, `soak_spatial`, `measure_spill`,
`bench_sweep`) against the reference's scripts in `bench/`, on the CPU.

Each reference script is loaded by path (as `bench/bench_step.py` loads
`make_settled_state.py`), never edited: its module-level `preset` is
monkeypatched to a small scene, its `SETTLED` table to paths in the
test's tmp directory with small criteria, and `sys.argv` to the depth.
The port's function runs the same scene and depth.  Compared: the step
and active count exactly; the audited policy's `healed`, `repaired`,
`rebuilds` (the reference's summed from its advances' outputs) and mode
exactly; x and ρ within rtol 1e-5, atol 1e-6, and v within 1e-3 of its
scale (ROADMAP Queue 3 item 7); the spill counts exactly; the printed
lines field by field (times and paths aside, printed floats to their
printed precision); the checkpoints, each file loaded by both packages.
No test writes under `bench/`.
"""

import dataclasses
import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import sph_tpu
import sph_tpu.decomp
import sph_tpu.step
import sph_tpu_torch as port
from helpers import small_scene
from sph_tpu.params import Block, Emitter
from sph_tpu_torch import (
    bench_sweep,
    decomp,
    make_settled_state,
    measure_spill,
    soak_1m,
    soak_emitters,
    soak_spatial,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
MODULES = {
    "make_settled_state": make_settled_state,
    "soak_1m": soak_1m,
    "soak_emitters": soak_emitters,
    "soak_spatial": soak_spatial,
    "measure_spill": measure_spill,
    "bench_sweep": bench_sweep,
}


def _snapshot():
    return {p: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(BENCH.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module", autouse=True)
def bench_untouched():
    """What `bench/` held before this file's first test."""
    return _snapshot()


def _script(name: str):
    """A fresh copy of `bench/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leap(scene):
    return dataclasses.replace(
        scene, params=dataclasses.replace(scene.params,
                                          integrator="leapfrog"))


def _calm():
    return _leap(small_scene(dim=2, seed=31))


def _jet():
    """The calm tank thrown sideways: every block of a dispatch heals."""
    base = _calm()
    b = base.blocks[0]
    return dataclasses.replace(
        base, blocks=(Block(lo=b.lo, hi=b.hi, velocity=(2000.0, 0.0)),))


def _fountain():
    """A pool under four nozzles (the regime of emitters3d: jets filling a
    pool), on the packed auto policy."""
    p = sph_tpu.SimParams(integrator="leapfrog")
    return sph_tpu.calibrate(sph_tpu.Scene(
        params=p, lo=(0.0, 0.0), hi=(300.0, 300.0),
        blocks=(Block(lo=(10.0, 10.0), hi=(290.0, 40.0)),),
        emitters=tuple(Emitter(pos=(x, 80.0), velocity=(0.0, -120.0),
                               width=6) for x in (40.0, 113.0, 187.0, 260.0)),
        capacity=2048, seed=5))


def _port_scene(ref_scene):
    return port.scene_from_json(sph_tpu.scene_to_json(ref_scene))


class _Counters:
    """Spies on the reference: the audited advances its script makes (their
    `healed`, `repaired`, `mode`) and the rebuilds its resident advances
    report in their outputs, which its audited advance does not keep."""

    def __init__(self, monkeypatch, script=None):
        self.made, self.rebuilds = [], 0
        real_adv = sph_tpu.step.make_advance
        real_sp = sph_tpu.decomp.make_spatial_advance

        def counted(out, at):
            if isinstance(out, tuple) and len(out) >= 4:
                self.rebuilds += int(out[at])
            return out

        def make_advance(*a, **kw):
            adv = real_adv(*a, **kw)
            return lambda st: counted(adv(st), 3)

        def make_spatial_advance(*a, **kw):
            adv = real_sp(*a, **kw)
            return lambda loc: counted(adv(loc), 2)

        monkeypatch.setattr(sph_tpu.step, "make_advance", make_advance)
        monkeypatch.setattr(sph_tpu.decomp, "make_spatial_advance",
                            make_spatial_advance)
        if script is not None:
            real = script.make_audited_advance

            def spy(*a, **kw):
                self.made.append(real(*a, **kw))
                return self.made[-1]

            monkeypatch.setattr(script, "make_audited_advance", spy)

    def policy(self):
        (adv,) = self.made
        return {"healed": int(adv.healed), "repaired": int(adv.repaired),
                "rebuilds": self.rebuilds, "mode": adv.mode}


def _run_script(mod, argv, monkeypatch, capsys, scene=None):
    """The script's main() on `scene` with `argv` → its stdout lines."""
    if scene is not None:
        monkeypatch.setattr(mod, "preset", lambda name: scene)
    monkeypatch.setattr(sys, "argv", [mod.__name__, *map(str, argv)])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines()


_TIMES = [
    (re.compile(r"wall\s+[\d.]+s"), "wall <s>"),
    (re.compile(r"in [\d.]+s"), "in <s>"),
    (re.compile(r"\s*[\d.e+-]+ particle-steps/s"), " <rate> particle-steps/s"),
    (re.compile(r"\s*[\d.e+-]+ psteps/s"), " <rate> psteps/s"),
    (re.compile(r"[\d.]+ ms/step"), "<ms> ms/step"),
    (re.compile(r"\s+<ms> ms/step"), " <ms> ms/step"),
]
_FLOAT = re.compile(r"-?\d+\.\d+")


def _same_lines(ours, ref, paths=()):
    """Printed lines equal field by field: times and `paths` masked,
    printed floats within their printed precision (one unit of the last
    digit, and 1e-4 relative)."""
    assert len(ours) == len(ref), (ours, ref)
    for a, b in zip(ours, ref):
        for ours_p, ref_p in paths:
            a = a.replace(str(ours_p), "<path>")
            b = b.replace(str(ref_p), "<path>")
        for pat, rep in _TIMES:
            a, b = pat.sub(rep, a), pat.sub(rep, b)
        assert _FLOAT.sub("<f>", a) == _FLOAT.sub("<f>", b), (a, b)
        for x, y in zip(_FLOAT.findall(a), _FLOAT.findall(b)):
            unit = 10.0 ** -len(x.split(".")[1])
            assert abs(float(x) - float(y)) <= unit + 1e-4 * abs(float(y)), \
                (a, b)


FIELDS = ("x", "v", "acc", "rho", "p", "kind", "emit_step", "step")


def _checkpoints_agree(ours_path, ref_path):
    """Each file loaded by both packages (the same arrays and scene from
    either loader), and the two states in agreement: the same step and
    active set, x and ρ within rtol 1e-5, atol 1e-6, v within 1e-3 of its
    scale."""
    r_st, r_sc = sph_tpu.diagnostics.load_checkpoint(str(ref_path))
    p_st, p_sc = port.load_checkpoint(str(ours_path), device="cpu")
    for path in (ref_path, ours_path):
        b, b_sc = sph_tpu.diagnostics.load_checkpoint(str(path))
        c, c_sc = port.load_checkpoint(str(path), device="cpu")
        assert sph_tpu.scene_to_json(b_sc) == port.scene_to_json(c_sc)
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(b, f)),
                                  getattr(c, f).numpy()), (path, f)
    assert sph_tpu.scene_to_json(r_sc) == port.scene_to_json(p_sc)
    _agree_v3(r_st, p_st, "checkpoint")
    return r_st, p_st


def _agree_v3(ref, ours, what=""):
    """`_agree` with v held to 1e-3 of its scale (Queue 3 item 7)."""
    assert np.array_equal(ours.active.numpy(), np.asarray(ref.active)), what
    assert int(ours.step) == int(ref.step), what
    for f in ("x", "rho"):
        a, b = np.asarray(getattr(ref, f)), getattr(ours, f).numpy()
        assert np.allclose(b, a, rtol=1e-5, atol=1e-6), (what, f)
    v_ref = np.asarray(ref.v)
    scale = max(np.abs(v_ref).max(), 1e-30)
    assert np.abs(ours.v.numpy() - v_ref).max() <= 1e-3 * scale, (what, "v")


# ---------------------------------------------------------------------------
# make_settled_state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", ["splash3d_1m", "emitters3d"])
def test_make_settled_state_matches_reference(config, tmp_path, monkeypatch,
                                              capsys):
    ref_scene = _calm() if config == "splash3d_1m" else _fountain()
    crit = (dict(n_steps=200) if config == "splash3d_1m"
            else dict(min_active=140, max_steps=300))
    ref_path, our_path = tmp_path / "ref.npz", tmp_path / "ours.npz"
    mod = _script("make_settled_state")
    monkeypatch.setattr(mod, "SETTLED", {config: (str(ref_path), crit)})
    spy = _Counters(monkeypatch, mod)
    ref_lines = _run_script(mod, [config], monkeypatch, capsys, ref_scene)
    ours = make_settled_state.regen(config, "cpu",
                                    scene=_port_scene(ref_scene),
                                    path=str(our_path), crit=crit)
    lines = capsys.readouterr().out.splitlines()
    _same_lines(lines, ref_lines, [(our_path, ref_path)])
    assert {k: ours[k] for k in ("healed", "repaired", "rebuilds",
                                 "mode")} == spy.policy()
    r_st, p_st = _checkpoints_agree(our_path, ref_path)
    assert ours["step"] == int(r_st.step) == int(p_st.step)
    assert ours["n_active"] == int(r_st.n_active())
    if config == "emitters3d":
        # stopped on min_active, short of max_steps, in whole dispatches
        # 96 in the pool, 24 more a dispatch: 144 at step 200
        assert int(sph_tpu.init(ref_scene).n_active()) == 120
        assert ours["n_active"] == 144 and ours["step"] == 200
        assert ours["mode"] in ("packed", "slot")
    else:
        assert ours["step"] == 200 and ours["mode"] == "cap8"


def test_make_settled_state_short_of_min_active_exits(tmp_path, monkeypatch,
                                                      capsys):
    crit = dict(min_active=10_000, max_steps=100)
    ref_path, our_path = tmp_path / "ref.npz", tmp_path / "ours.npz"
    mod = _script("make_settled_state")
    monkeypatch.setattr(mod, "SETTLED", {"emitters3d": (str(ref_path), crit)})
    with pytest.raises(SystemExit) as ref_exit:
        _run_script(mod, ["emitters3d"], monkeypatch, capsys, _fountain())
    with pytest.raises(SystemExit) as our_exit:
        make_settled_state.regen("emitters3d", "cpu",
                                 scene=_port_scene(_fountain()),
                                 path=str(our_path), crit=crit)
    assert str(our_exit.value) == str(ref_exit.value)
    assert "only" in str(our_exit.value)
    assert not ref_path.exists() and not our_path.exists()


def test_settled_table_and_main_skip_existing(tmp_path, monkeypatch, capsys):
    ref = _script("make_settled_state")
    assert {k: Path(p).relative_to(BENCH) for k, (p, _) in
            make_settled_state.SETTLED.items()} == {
        k: Path(p).relative_to(BENCH) for k, (p, _) in ref.SETTLED.items()}
    assert {k: c for k, (_, c) in make_settled_state.SETTLED.items()} == {
        k: c for k, (_, c) in ref.SETTLED.items()}
    for config in ref.SETTLED:
        assert (Path(make_settled_state.settled_path(config)).name
                == Path(ref.settled_path(config)).name)
    assert make_settled_state.settled_path("dam3d_100k") is None
    # the bench reads the maker's table
    from sph_tpu_torch import bench_step
    assert bench_step.settled_path is make_settled_state.settled_path
    # main skips a checkpoint that exists, unless named
    table = {k: (str(tmp_path / f"{k}.npz"), c)
             for k, (_, c) in make_settled_state.SETTLED.items()}
    for path, _ in table.values():
        Path(path).write_bytes(b"")
    monkeypatch.setattr(make_settled_state, "SETTLED", table)
    made = []
    monkeypatch.setattr(make_settled_state, "regen",
                        lambda config, device: made.append(config))
    assert make_settled_state.main(["--device", "cpu"]) == 0
    assert made == [] and capsys.readouterr().out.count("skipping") == 2
    assert make_settled_state.main(["emitters3d", "--device", "cpu"]) == 0
    assert made == ["emitters3d"]
    with pytest.raises(SystemExit) as e:
        make_settled_state.main(["dam3d_100k", "--device", "cpu"])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# the soaks
# ---------------------------------------------------------------------------


def test_soak_1m_matches_reference(monkeypatch, capsys):
    """The jet outgrows cap 8 in the warm dispatch (the cap-8 → cap-16
    switch) and heals on cap 16: probe lines at every change of `healed`."""
    ref_scene = _jet()
    mod = _script("soak_1m")
    spy = _Counters(monkeypatch, mod)
    ref_lines = _run_script(mod, [200], monkeypatch, capsys, ref_scene)
    ours = soak_1m.soak(200, device="cpu", scene=_port_scene(ref_scene))
    lines = capsys.readouterr().out.splitlines()
    _same_lines(lines, ref_lines)
    assert {k: ours[k] for k in ("healed", "repaired", "rebuilds",
                                 "mode")} == spy.policy()
    assert ours["mode"] == "cap16" and ours["modes"][-1] == (100, "cap16")
    assert ours["healed"] > 0 and lines[-1].startswith("SOAK RESULT: 100 ")
    assert ours["n_final"] == ours["n"] == int(sph_tpu.init(ref_scene)
                                               .n_active())


@pytest.mark.parametrize("kind", ["vortex", "fill"])
def test_soak_emitters_matches_reference(kind, tmp_path, monkeypatch,
                                         capsys):
    """`vortex`: a non-emitter scene whose every block heals, so the
    policy demotes to per step (vortex2d's regime); `fill`: the nozzle
    filling an empty tank on the packed auto policy, its final state
    saved by both to the tmp directory."""
    config = "vortex2d" if kind == "vortex" else "emitters3d"
    ref_scene = _jet() if kind == "vortex" else _fountain()
    n_steps = 200
    ref_path, our_path = tmp_path / "ref.npz", tmp_path / "ours.npz"
    mod = _script("soak_emitters")
    spy = _Counters(monkeypatch, mod)
    argv = [config, n_steps] + ([ref_path] if kind == "fill" else [])
    ref_lines = _run_script(mod, argv, monkeypatch, capsys, ref_scene)
    ours = soak_emitters.soak(config, n_steps,
                              str(our_path) if kind == "fill" else None,
                              "cpu", scene=_port_scene(ref_scene))
    lines = capsys.readouterr().out.splitlines()
    _same_lines(lines, ref_lines, [(our_path, ref_path)])
    assert {k: ours[k] for k in ("healed", "repaired", "rebuilds",
                                 "mode")} == spy.policy()
    if kind == "vortex":
        assert ours["mode"] == "perstep" and ours["healed"] >= 8
        assert not ref_path.exists() and not our_path.exists()
    else:
        assert ours["mode"] == "packed" and ours["n_final"] > 0
        r_st, _ = _checkpoints_agree(our_path, ref_path)
        assert ours["n_final"] == int(r_st.n_active())


def test_soak_emitters_probe_every_is_the_reference():
    for n in (300, 5000, 40_000, 260_000):
        assert soak_emitters.probe_every(n) == max(1000, n // 40 // 100 * 100)
    assert soak_emitters.DEFAULTS == _script("soak_emitters").DEFAULTS
    assert Path(soak_emitters.FULL_SETTLED).name == \
        ".settled_emitters3d_full.npz"


def test_zz_nothing_written_under_bench(bench_untouched):
    """Every test above wrote its checkpoints to its tmp directory."""
    assert _snapshot() == bench_untouched


# ---------------------------------------------------------------------------
# The reference's arc, for the card's long runs
# ---------------------------------------------------------------------------


def reference_arc(name: str, n_steps: int, method: str = "pallas") -> None:
    """Print the reference's trajectory of preset `name` on the CPU by its
    bulk statistics, after every dispatch of 100 steps of
    `sph_tpu.step.make_advance(scene, method, 100)` (per step; Pallas in
    interpret mode) from the preset's init, primed under leapfrog: the
    step, the mean ρ over the active particles and max |v_k| over their
    components, as the soaks print them.  A long run of the port on the
    card parts from the reference's by rounding, so it is held to these,
    not particle by particle:

        python tests/test_torch_soak.py vortex2d 5000 [method=pallas]
    """
    import time

    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    scene = sph_tpu.preset(name)
    state = sph_tpu.init(scene)
    if scene.params.integrator == "leapfrog":
        state = jax.jit(lambda s: sph_tpu.step.prime(scene, s,
                                                     method=method))(state)
    adv = sph_tpu.step.make_advance(scene, method, steps_per_dispatch=100)
    t0 = time.perf_counter()
    for _ in range(n_steps // 100):
        state = adv(state)
        act = state.active
        rho = float(jnp.sum(jnp.where(act, state.rho, 0.0))
                    / jnp.maximum(jnp.sum(act), 1))
        vmax = float(jnp.max(jnp.abs(jnp.where(act[:, None], state.v, 0.0))))
        print(f"step {int(state.step):6d}  rho_mean={rho:9.2f}  "
              f"max|v|={vmax:7.1f}  n={int(jnp.sum(act))}  "
              f"wall {time.perf_counter() - t0:7.1f}s", flush=True)


if __name__ == "__main__":
    reference_arc(sys.argv[1], int(sys.argv[2]), *sys.argv[3:4])
