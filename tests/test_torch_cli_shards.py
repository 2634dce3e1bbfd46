"""The port's decomposed command line under `torchrun` (`python -m
torch.distributed.run --standalone`, gloo on the CPU), against the
reference CLI run in-process with the same flags on the 8-device CPU
mesh (tests/test_diagnostics.py:286-320, 628-660; tests/test_emitter.py:
278-300):

  * `run tutorial2d --shards 2x2` on four processes: pencils, the pencil
    note and the backend line once each on stderr, one `metrics.jsonl`
    line a frame written by rank 0 alone, the reference's keys, and its
    `step`, `shards`, `mesh` and `n_active`;
  * `run tutorial2d --shards 2 --method grid --interact` with a spawn on
    two processes: rank 0 reads the command and every rank folds it, so
    `n_active` grows by the reference's count.

In process: the rule that gives each rank its device and the group its
backend (`--device cuda`: cuda:LOCAL_RANK over NCCL; `cuda:K`: card K,
over gloo when the machine runs more than one rank; `cpu`: gloo), a rank
past the machine's cards (one line), and a launch whose process count is
not the `--shards` rank count (exit 2, one line naming torchrun).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sph_tpu import cli as ref_cli
from sph_tpu_torch import cli

ROOT = Path(__file__).resolve().parents[1]


def _torchrun(nproc: int, argv: list, cwd) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "sph_tpu_torch.cli", *argv,
         "--device", "cpu"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _metrics(out) -> list:
    return [json.loads(ln) for ln in
            (out / "metrics.jsonl").read_text().strip().splitlines()]


def _same_frames(ours: list, ref: list, frames: int) -> None:
    assert len(ours) == len(ref) == frames     # one line a frame, once
    for a, b in zip(ours, ref):
        assert set(a) == set(b)
        for k in ("frame", "step", "shards", "mesh", "n_active"):
            assert a.get(k) == b.get(k), k
        assert abs(a["mean_rho"] - b["mean_rho"]) <= 1e-5 * b["mean_rho"]


def test_torchrun_pencils_metrics_match_reference(tmp_path):
    argv = ["run", "tutorial2d", "--shards", "2x2", "--frames", "2",
            "--steps-per-frame", "8", "--render", "--width", "80",
            "--height", "60", "--quiet"]
    assert ref_cli.main([*argv, "--out", str(tmp_path / "ref")]) == 0
    res = _torchrun(4, [*argv, "--out", str(tmp_path / "ours")], tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    ours, ref = _metrics(tmp_path / "ours"), _metrics(tmp_path / "ref")
    _same_frames(ours, ref, 2)
    assert ours[-1]["mesh"] == "2x2" and ours[-1]["shards"] == 4
    assert ours[-1]["step"] == 16
    assert sorted(p.name for p in (tmp_path / "ours").iterdir()) == [
        "frame_00000.png", "frame_00001.png", "metrics.jsonl"]
    err = res.stderr
    assert err.count("note: pencil decomposition steps per-step") == 1
    assert err.count("gloo backend") == 1


def test_torchrun_slabs_interact_spawn_matches_reference(tmp_path):
    cmds = tmp_path / "cmds.jsonl"
    cmds.write_text(json.dumps(
        {"spawn": {"pos": [200.0, 250.0], "n": 24}}) + "\n")
    argv = ["run", "tutorial2d", "--method", "grid", "--shards", "2",
            "--frames", "2", "--steps-per-frame", "4", "--interact",
            str(cmds), "--quiet"]
    assert ref_cli.main([*argv, "--out", str(tmp_path / "ref")]) == 0
    res = _torchrun(2, [*argv, "--out", str(tmp_path / "ours")], tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    ours, ref = _metrics(tmp_path / "ours"), _metrics(tmp_path / "ref")
    _same_frames(ours, ref, 2)
    assert ours[-1]["shards"] == 2 and "mesh" not in ours[-1]
    assert res.stderr.count("interact: spawned 24") == 1
    base = ref_cli._fresh_state(ref_cli._load_scene("tutorial2d"), "grid")
    assert ours[-1]["n_active"] >= int(base.n_active()) + 24


# (env, --device) → (device, backend) of the rank, the card count 2
DEVICE_RULE = {
    "cpu": ({}, "cpu", ("cpu", "gloo")),
    "cuda_local_rank": ({"LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
                        "cuda", ("cuda:1", "nccl")),
    "pinned_one_rank": ({"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"},
                        "cuda:1", ("cuda:1", "nccl")),
    "pinned_four_ranks": ({"LOCAL_RANK": "3", "LOCAL_WORLD_SIZE": "4"},
                          "cuda:0", ("cuda:0", "gloo")),
}


@pytest.mark.parametrize("case", sorted(DEVICE_RULE))
def test_rank_device_and_backend_rule(case, monkeypatch):
    env, arg, want = DEVICE_RULE[case]
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    dev, backend = cli._rank_device(arg)
    assert (str(dev), backend) == want


def test_a_rank_past_the_cards_is_one_line(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="has 2 card") as e:
        cli._rank_device("cuda")
    assert "\n" not in str(e.value)


def test_a_launch_of_the_wrong_size_exits_2_naming_torchrun(monkeypatch,
                                                            capsys):
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert cli.main(["run", "tutorial2d", "--shards", "2", "--device",
                     "cpu"]) == 2
    err = capsys.readouterr().err.strip()
    assert "torchrun --nproc-per-node 2" in err and "\n" not in err
