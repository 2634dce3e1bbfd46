"""The port's bench (`python -m sph_tpu_torch.cli bench`,
`sph_tpu_torch/bench_step.py`) against the reference's
(`bench/bench_step.py`, loaded by path as `sph_tpu/cli.py:911-935` loads
it), on the CPU.

The table has the reference's rows in the reference's order and its
floors' keys (read from the reference's source without running it); the
tutorial2d rows print the same tags, `n` and JSON keys; the `@settled`
rows are unavailable without their checkpoints in both; each row makes
its advance with the reference's dispatch length and options on the same
state (`sort_every`, `slot_resident`, `auto_rebuild`, `packed_rows`,
`repair_k`, the cap-8 flag); `--assert-floor` exits 1 under a floor; with
no card the command stops with one line.  The chain target is cut in
both, which changes only how long a timed window is.
"""

import ast
import functools
import importlib.util
import json
import re
import sys
from pathlib import Path

import pytest
import torch

import sph_tpu.decomp
import sph_tpu.step
from sph_tpu_torch import bench_step, cli, decomp

torch.set_num_threads(1)

REF_PATH = Path(__file__).resolve().parent.parent / "bench" / "bench_step.py"
TARGET_S = 0.05


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_bench_step", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def short_chains(ref, monkeypatch):
    monkeypatch.setattr(bench_step, "CHAIN_TARGET_S", TARGET_S)
    monkeypatch.setattr(ref, "timed_chain",
                        functools.partial(ref.timed_chain, target_s=TARGET_S))


def _ref_literal(name: str):
    """The value of the reference's top-level assignment `name`, read from
    its source."""
    tree = ast.parse(REF_PATH.read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == [name]):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_configs_and_floor_keys_are_the_reference():
    assert bench_step.CONFIGS == _ref_literal("CONFIGS")
    floors = _ref_literal("FLOORS")
    assert set(bench_step.FLOORS) == set(floors)
    # the reference's floors are TPU figures: none is kept
    assert not any(bench_step.FLOORS[k] == v for k, v in floors.items())


def _table(text: str):
    """(tag → n or the UNAVAILABLE text, the JSON list) of a printed
    table."""
    lines = text.strip().splitlines()
    rows = {}
    for ln in lines[:-1]:
        tag, rest = ln.split(None, 1)
        n = re.match(r"n=\s*(\d+) ", rest)
        rows[tag] = int(n.group(1)) if n else rest
    return rows, json.loads(lines[-1])


def _ref_main(ref, monkeypatch, argv) -> int:
    monkeypatch.setattr(sys, "argv", ["bench_step", *argv])
    return ref.main()


def test_tutorial2d_rows_match_reference(ref, short_chains, monkeypatch,
                                         capsys):
    argv = ["--steps", "4", "--only", "tutorial2d"]
    assert _ref_main(ref, monkeypatch, argv) == 0
    ref_rows, ref_json = _table(capsys.readouterr().out)
    assert cli.main(["bench", *argv, "--device", "cpu"]) == 0
    rows, out = _table(capsys.readouterr().out)
    assert rows == ref_rows == {"tutorial2d/naive": 1034,
                                "tutorial2d/grid": 1034,
                                "tutorial2d/pallas": 1034}
    assert [set(r) for r in out] == [set(r) for r in ref_json]
    assert [(r["config"], r["method"], r["n"]) for r in out] == [
        (r["config"], r["method"], r["n"]) for r in ref_json]
    assert all(r["particle_steps_per_s"] > 0 for r in out)


def test_settled_rows_unavailable_without_checkpoints(ref, monkeypatch,
                                                      capsys):
    argv = ["--only", "settled"]
    assert _ref_main(ref, monkeypatch, argv) == 0
    ref_rows, ref_json = _table(capsys.readouterr().out)
    assert cli.main(["bench", *argv, "--device", "cpu"]) == 0
    rows, out = _table(capsys.readouterr().out)
    assert out == ref_json == []
    assert set(rows) == set(ref_rows) == {
        "splash3d_1m@settled/resident4auto",
        "emitters3d@settled/resident4auto"}
    for r in (rows, ref_rows):
        assert all(v.startswith("UNAVAILABLE: FileNotFoundError")
                   for v in r.values())


class _Made(Exception):
    """Raised by the spies once a row has made its advance."""


def _spy(made: list):
    """A factory that records what it is given (its plain positional
    values and its keywords but the device) and stops the row."""

    def spy(*args, **kw):
        kw.pop("device", None)
        pos = tuple(a for a in args if isinstance(a, (bool, int, str)))
        made.append((pos, kw))
        raise _Made

    return spy


ROWS = [
    ("dam2d_10k", "resident4"),
    ("dam2d_10k", "resident4auto"),
    ("dam3d_100k", "resident4auto"),    # repair_k resolves to 2048
    ("emitters3d", "resident4auto"),    # packed_fits: packed rows
    ("dam2d_10k", "auto8"),
    ("emitters3d", "pallas"),
    ("vortex2d", "audited4"),
    ("dam2d_10k", "spatial-resident4auto"),
    ("dam2d_10k", "pencil"),
]


@pytest.mark.parametrize("steps", [30, 250])
@pytest.mark.parametrize("name,method", ROWS,
                         ids=[f"{n}/{m}" for n, m in ROWS])
def test_row_advance_arguments_match_reference(ref, monkeypatch, name,
                                               method, steps):
    ref_made, made = [], []
    # the leapfrog prime changes the state, not the arguments: skip it
    monkeypatch.setattr(ref, "prime", lambda scene, s, method: s)
    monkeypatch.setattr(bench_step, "prime", lambda scene, s, **kw: s)
    monkeypatch.setattr(ref, "make_advance", _spy(ref_made))
    monkeypatch.setattr(sph_tpu.step, "make_audited_advance", _spy(ref_made))
    monkeypatch.setattr(sph_tpu.decomp, "make_spatial_advance",
                        _spy(ref_made))
    monkeypatch.setattr(sph_tpu.decomp, "make_audited_pencil_advance",
                        _spy(ref_made))
    monkeypatch.setattr(bench_step, "make_advance", _spy(made))
    monkeypatch.setattr(bench_step, "make_audited_advance", _spy(made))
    monkeypatch.setattr(decomp, "make_spatial_advance", _spy(made))
    monkeypatch.setattr(decomp, "make_audited_pencil_advance", _spy(made))
    with pytest.raises(_Made):
        ref.bench_one(name, method, steps)
    with pytest.raises(_Made):
        bench_step.bench_one(name, method, steps, device="cpu")
    assert made == ref_made and len(made) == 1
    # the reference bench's dispatch: at most 100 steps, whole blocks
    pos, kw = made[0]
    spd = kw["steps_per_dispatch"] if "steps_per_dispatch" in kw else pos[-1]
    blocks = 1 if method in ("pallas", "pencil") else 4
    assert spd == min(steps, 100) // blocks * blocks
    # the one-rank group of the decomposed rows is gone with the row
    assert not torch.distributed.is_initialized()


def test_assert_floor_exits_1_under_a_floor(monkeypatch, capsys):
    monkeypatch.setattr(bench_step, "CHAIN_TARGET_S", TARGET_S)
    argv = ["bench", "--steps", "2", "--only", "tutorial2d/naive",
            "--device", "cpu", "--assert-floor"]
    monkeypatch.setattr(bench_step, "FLOORS",
                        {("tutorial2d", "naive"): 1e30})
    assert cli.main(argv) == 1
    out = capsys.readouterr()
    assert "REGRESSION (< 1.00e+30)" in out.out and "FAILED floors" in out.err
    monkeypatch.setattr(bench_step, "FLOORS", {})
    assert cli.main(argv) == 0
    assert "REGRESSION" not in capsys.readouterr().out


def test_no_card_is_one_line_and_bad_flags_exit_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["bench", "--only", "tutorial2d/naive"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and len(out.err.strip().splitlines()) == 1
    assert "no CUDA device" in out.err
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--steps", "many"])
    assert e.value.code == 2


def test_profile_writes_a_trace_a_row(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench_step, "CHAIN_TARGET_S", TARGET_S)
    prof = tmp_path / "prof"
    assert bench_step.main(["--steps", "2", "--only", "tutorial2d/naive",
                            "--device", "cpu", "--profile", str(prof)]) == 0
    trace = json.loads((prof / "tutorial2d_naive.json").read_text())
    assert trace["traceEvents"]
    assert "tutorial2d/naive" in capsys.readouterr().out
