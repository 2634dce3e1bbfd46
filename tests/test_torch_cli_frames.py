"""The port's command line takes the reference CLI's steps a frame when
`--steps-per-frame` exceeds the reference's frame split (100 steps on
`--method pallas`, which `--method auto` resolves to).

The reference runs such a frame as ceil(S / 100) dispatches of
ceil(S / inner) steps each, rounded down to a multiple of `--sort-every`
(`sph_tpu/cli.py:530-538`, `:730-736`, and the decomposed loops).  Both
command lines run in-process on tutorial2d with `--device cpu` for the
port; `step` in `metrics.jsonl` (and, for `record`, the step after every
dispatch) must be equal.
"""

import json

import pytest
import torch

from sph_tpu import cli as ref_cli
from sph_tpu_torch import cli

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def _steps(out) -> list:
    return [json.loads(ln)["step"] for ln in
            (out / "metrics.jsonl").read_text().strip().splitlines()]


@pytest.mark.parametrize("flags,spf,want", [
    (["--method", "pallas"], 101, [102, 204]),   # 2 dispatches of 51
    ([], 250, [252, 504]),      # auto: 3 dispatches of 84, rounded to 84
    (["--shards", "1", "--method", "pallas"], 101, [102]),  # slabs: 2 of 51
], ids=["pallas_101", "auto_250", "shards1_101"])
def test_run_steps_a_frame_match_reference(flags, spf, want, tmp_path):
    frames = len(want)
    argv = ["run", "tutorial2d", "--frames", str(frames),
            "--steps-per-frame", str(spf), "--quiet", *flags]
    assert ref_cli.main([*argv, "--out", str(tmp_path / "ref")]) == 0
    assert cli.main([*argv, "--out", str(tmp_path / "ours"), *CPU]) == 0
    assert _steps(tmp_path / "ours") == _steps(tmp_path / "ref") == want


def test_debug_splits_without_rounding(tmp_path):
    """--debug steps one at a time: the reference splits its frame the same
    way and rounds nothing (2 dispatches of 51 for 101)."""
    assert cli.main(["run", "tutorial2d", "--debug", "--frames", "1",
                     "--steps-per-frame", "101", "--out", str(tmp_path),
                     "--quiet", *CPU]) == 0
    assert _steps(tmp_path) == [102]


def _dispatch_ends(monkeypatch, module) -> list:
    """Record the step after every dispatch of the advances `module`'s
    command line makes."""
    ends = []
    real = module.make_audited_advance

    def spy(*args, **kw):
        adv = real(*args, **kw)

        def counted(st):
            st = adv(st)
            ends.append(int(st.step))
            return st

        return counted

    monkeypatch.setattr(module, "make_audited_advance", spy)
    return ends


def test_record_dispatches_match_reference(tmp_path, monkeypatch):
    argv = ["record", "tutorial2d", "--method", "pallas", "--frames", "1",
            "--steps-per-frame", "101", "--width", "40", "--height", "30",
            "--quiet"]
    ref_ends = _dispatch_ends(monkeypatch, ref_cli)
    assert ref_cli.main([*argv, "--out", str(tmp_path / "ref.apng")]) == 0
    ends = _dispatch_ends(monkeypatch, cli)
    assert cli.main([*argv, "--out", str(tmp_path / "ours.apng"), *CPU]) == 0
    assert ends == ref_ends == [51, 102]
