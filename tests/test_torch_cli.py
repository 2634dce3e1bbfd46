"""The port's command line (`python -m sph_tpu_torch.cli`) against the
reference's (`sph_tpu.cli.main`, run in-process), with `--device cpu`.

With the same flags, `metrics.jsonl` has the reference CLI's keys, the
same step, mode and counters, and its frame scalars agree within 1e-5
relative (of the momentum's scale for the momentum, a sum that cancels).
Frames of at most 100 steps, where the two dispatch plans agree (the
reference splits longer pallas frames; ROADMAP.md Queue 3 item 4).  The
reference's contradictory flag sets exit 2 with one line; `--shards` with
more ranks than the launch has exits 2 with one line naming `torchrun`
(test_torch_cli_shards.py runs it under torchrun); live interaction
spawns and resets.
"""

import json
import struct

import pytest
import torch

from sph_tpu import cli as ref_cli
from sph_tpu_torch import cli

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def _metrics(out) -> list:
    return [json.loads(ln) for ln in
            (out / "metrics.jsonl").read_text().strip().splitlines()]


def _close(ours: dict, ref: dict) -> None:
    """The same keys; the same integers, strings and flags; floats within
    1e-5 relative (momentum: of the largest momentum component)."""
    assert set(ours) == set(ref)
    mom = max(abs(ref[f"momentum_{a}"]) for a in "xyz")
    for k, b in ref.items():
        if k == "wall_s":
            continue
        if isinstance(b, float):
            scale = mom if k.startswith("momentum") else abs(b)
            assert abs(ours[k] - b) <= 1e-5 * scale, (k, ours[k], b)
        else:
            assert ours[k] == b, (k, ours[k], b)


@pytest.mark.parametrize("flags", [
    [],                                  # --method auto: resident4auto
    ["--adaptive-cap"],                  # auto + the cap-8 policy
    ["--method", "grid"],
], ids=["auto", "adaptive_cap", "grid"])
def test_run_metrics_match_reference(flags, tmp_path):
    argv = ["run", "tutorial2d", "--frames", "2", "--steps-per-frame", "12",
            "--quiet", *flags]
    assert ref_cli.main([*argv, "--out", str(tmp_path / "ref")]) == 0
    assert cli.main([*argv, "--out", str(tmp_path / "ours"), *CPU]) == 0
    ref, ours = _metrics(tmp_path / "ref"), _metrics(tmp_path / "ours")
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        _close(a, b)
    assert ours[-1]["step"] == 24
    if "--method" not in flags:
        assert ours[-1]["advance_mode"] == ref[-1]["advance_mode"]
        assert ours[-1]["cap_dropped"] == ours[-1]["row_overflow"] == 0


def test_run_render_checkpoint_resume_and_debug(tmp_path):
    out = tmp_path / "o"
    assert cli.main(["run", "tutorial2d", "--frames", "2",
                     "--steps-per-frame", "8", "--render", "--width", "80",
                     "--height", "60", "--checkpoint-every", "1",
                     "--out", str(out), "--quiet", *CPU]) == 0
    png = (out / "frame_00001.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert struct.unpack(">II", png[16:24]) == (80, 60)
    again = tmp_path / "r"
    assert cli.main(["run", "tutorial2d", "--frames", "1",
                     "--steps-per-frame", "8", "--resume",
                     str(out / "ckpt_00001.npz"), "--out", str(again),
                     "--quiet", *CPU]) == 0
    assert _metrics(again)[-1]["step"] == 24
    dbg = tmp_path / "d"
    assert cli.main(["run", "tutorial2d", "--debug", "--frames", "1",
                     "--steps-per-frame", "4", "--out", str(dbg),
                     "--quiet", *CPU]) == 0
    rec = _metrics(dbg)[-1]
    assert rec["step"] == 4 and rec["cap_dropped"] == 0


def test_record_writes_an_apng(tmp_path, capsys):
    path = tmp_path / "movie.apng"
    assert cli.main(["record", "tutorial2d", "--frames", "3",
                     "--steps-per-frame", "8", "--width", "60", "--height",
                     "40", "--out", str(path), "--quiet", *CPU]) == 0
    data = path.read_bytes()
    i = data.index(b"acTL") + 4
    assert struct.unpack(">I", data[i:i + 4]) == (3,)
    assert "wrote" in capsys.readouterr().out


def test_presets_list_equals_reference(capsys):
    assert ref_cli.main(["presets"]) == 0
    ref = capsys.readouterr().out
    assert cli.main(["presets"]) == 0
    assert capsys.readouterr().out == ref


BAD = [
    ["run", "tutorial2d", "--repair-k", "4", "--strict-audit"],
    ["run", "tutorial2d", "--method", "pallas", "--resident"],
    ["run", "tutorial2d", "--method", "grid", "--sort-every", "4"],
    ["run", "tutorial2d", "--method", "pallas", "--repair-k", "4"],
    ["run", "tutorial2d", "--method", "pallas", "--adaptive-cap"],
    ["run", "tutorial2d", "--repair-k", "-1"],
    ["record", "tutorial2d", "--repair-k", "4", "--strict-audit"],
]


@pytest.mark.parametrize("argv", BAD, ids=range(len(BAD)))
def test_bad_flag_combos_exit_2_like_the_reference(argv, capsys,
                                                   monkeypatch):
    # validation comes before the device: with no card it still exits 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ref_cli.main(argv) == 2
    want = capsys.readouterr().err
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert err == want and len(err.strip().splitlines()) == 1
    assert "Traceback" not in err


@pytest.mark.parametrize("shards", ["2", "2x2"])
def test_shards_exit_2_naming_item_14(shards, capsys, monkeypatch):
    # one process, no torchrun world: the missing world is a usage error
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert cli.main(["run", "tutorial2d", "--shards", shards, *CPU]) == 2
    err = capsys.readouterr().err.strip()
    n = 4 if "x" in shards else 2
    assert f"torchrun --nproc-per-node {n}" in err and "\n" not in err
    assert "Traceback" not in err


def test_interact_spawn_and_reset(tmp_path, capsys):
    cmds = tmp_path / "cmds.jsonl"
    cmds.write_text(
        json.dumps({"spawn": {"pos": [300.0, 300.0], "n": 24}}) + "\n"
        + json.dumps({"spawn": {"pos": [300.0], "n": 8}}) + "\n"
        + "not json\n"
    )
    out = tmp_path / "o"
    argv = ["run", "tutorial2d", "--frames", "1", "--steps-per-frame", "8",
            "--interact", str(cmds), "--out", str(out), "--quiet", *CPU]
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    assert "interact: spawned 24" in err
    assert "spawn ignored" in err and "bad JSON line ignored" in err
    base = tmp_path / "b"
    assert cli.main(["run", "tutorial2d", "--frames", "1",
                     "--steps-per-frame", "8", "--out", str(base),
                     "--quiet", *CPU]) == 0
    assert _metrics(out)[-1]["n_active"] == _metrics(base)[-1]["n_active"] + 24
    # a reset re-seeds: resumed at step 24, the clock restarts at 0
    assert cli.main(["run", "tutorial2d", "--frames", "3",
                     "--steps-per-frame", "8", "--checkpoint-every", "3",
                     "--out", str(base), "--quiet", *CPU]) == 0
    cmds.write_text(json.dumps({"reset": True}) + "\n")
    reset = tmp_path / "r"
    assert cli.main(["run", "tutorial2d", "--frames", "2",
                     "--steps-per-frame", "8", "--interact", str(cmds),
                     "--resume", str(base / "ckpt_00002.npz"),
                     "--out", str(reset), "--quiet", *CPU]) == 0
    assert "interact: scene reset" in capsys.readouterr().err
    assert [r["step"] for r in _metrics(reset)] == [8, 16]
