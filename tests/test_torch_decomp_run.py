"""`sph_tpu_torch.run(shards=2)` on a two-rank gloo world of spawned
processes (`torch_decomp_worker.py`, suite "run"), held to the contract the
reference states for its own `run(shards=)` (tests/test_domain_decomp.py:
1220-1274):

  * per-step grid slabs give the single-device trajectory bit for bit,
    order-insensitively (the gathered capacity is rank-padded), and
    `frame_callback` sees the global state after each dispatch, at steps
    [5, 10, 13] for 13 steps in dispatches of 5;
  * `packed_rows` is ignored with a notice and changes nothing;
  * a dispatch that overflows its spec's buffers is re-run from its input
    on a spec rebuilt from the gathered state (elastic recovery), and the
    run ends bit for bit where a run that never overflowed ends;
  * method="pallas" (K1/K2 through the split API on slab-local lattices,
    their plain versions here) conserves the particles and tracks the
    single-device pallas run within 1e-4 of the position scale;
  * the slab fast path, `sort_every=4, slot_resident=True`, with dispatches
    rounded down to 8 steps and a remainder that keeps the fast path (20 =
    2·8 + 4) or runs per step (18 = 2·8 + 2), conserves and tracks the
    single-device run of the same options within 1e-4 of the scale.
"""

import numpy as np
import pytest

import torch_decomp_worker as worker

WORLD = 2


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("decomp_run")
    got = worker.join(worker.spawn("run", WORLD, out), out)
    got["log"] = (out / "rank0.log").read_text()
    return got


def _active_sorted(prefix, r):
    act = r[f"{prefix}_emit_step"] <= int(r[f"{prefix}_step"])
    x = r[f"{prefix}_x"][act]
    return x[np.lexsort(x.T)]


def test_run_shards_matches_single_device(results):
    r = results["run"]
    assert int(r["m_step"]) == 13 and list(r["frames"]) == [5, 10, 13]
    assert r["m_x"].shape[0] % WORLD == 0
    xa, xb = _active_sorted("m", r), _active_sorted("ref", r)
    assert xa.shape == xb.shape
    assert np.array_equal(xa, xb)


def test_run_shards_ignores_packed_rows(results):
    r = results["run_packed_rows"]
    assert "packed_rows is single-chip only" in results["log"]
    assert int(r["step"]) == 6
    assert np.array_equal(r["a_x"], r["b_x"])


def test_run_shards_respecs_on_overflow(results):
    r = results["run_elastic"]
    assert int(r["specs"]) == 2    # the first spec, then the rebuilt one
    # the rebuilt spec is sized from the gathered (rank-padded) capacity,
    # so the two end on different capacities: compare order-insensitively
    xs = []
    for p in "ab":
        act = r[f"{p}_emit"] <= 8
        xs.append(r[f"{p}_x"][act][np.lexsort(r[f"{p}_x"][act].T)])
    assert xs[0].shape == xs[1].shape
    assert np.array_equal(*xs)


def test_run_shards_pallas_tracks_single_device(results):
    r = results["run_pallas"]
    act = r["m_emit_step"] <= int(r["m_step"])
    act_r = r["ref_emit_step"] <= int(r["ref_step"])
    assert int(r["m_step"]) == int(r["ref_step"]) == 6
    assert act.sum() == act_r.sum()
    xa, xb = _active_sorted("m", r), _active_sorted("ref", r)
    scale = np.max(np.abs(xb)) + 1e-6
    assert np.max(np.abs(xa - xb)) / scale < 1e-4


@pytest.mark.parametrize("n", [20, 18])
def test_run_shards_fast_path_tracks_single_device(results, n):
    r = results["run_fast"]
    assert int(r[f"m{n}_step"]) == int(r[f"ref{n}_step"]) == n
    assert list(r[f"frames{n}"]) == [8, 16, n]
    act = r[f"m{n}_emit_step"] <= n
    act_r = r[f"ref{n}_emit_step"] <= n
    assert act.sum() == act_r.sum()
    xa, xb = _active_sorted(f"m{n}", r), _active_sorted(f"ref{n}", r)
    scale = np.max(np.abs(xb)) + 1e-6
    assert np.max(np.abs(xa - xb)) / scale < 1e-4
