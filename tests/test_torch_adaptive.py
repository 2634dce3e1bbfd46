"""The cap-8 adaptive policy of the port (`make_audited_advance(...,
adaptive_cap=True)`) against the reference's, with the same dispatch plan
in both packages, on the reference's own cases
(tests/test_pallas_equiv.py:447-540): a calm scene holds cap 8, a jet
switches to the default cap, and a cluster that straddles a cell of the
narrower lattice narrows the skin to fit.

Each checks that the mode, the healed blocks, the switch step and the
chosen skin equal the reference's; x and rho agree within rtol=1e-5,
atol=1e-6 and v as ROADMAP.md Queue 3 item 7 (helpers of
tests/test_torch_resident.py); and the switched run is bitwise the port's
own per-step run from the same state.
"""

import re

import jax.numpy as jnp
import numpy as np
import torch

import sph_tpu_torch as port
from helpers import small_scene
from sph_tpu import neighbors as ref_nb
from sph_tpu.state import State as RefState
from sph_tpu.step import default_skin as ref_default_skin
from sph_tpu.step import make_audited_advance as ref_make_audited
from test_torch_resident import CPU, _agree, _jet, _pair, _same

torch.set_num_threads(1)

KW = dict(sort_every=4, slot_resident=True, adaptive_cap=True)


def _both(capsys, rs, rst, scene, ost, spd=12):
    """One dispatch of each package's cap-8 policy: (ref out, ref advance,
    ref stderr, port out, port advance, port stderr)."""
    ref_adv = ref_make_audited(rs, "pallas", spd, **KW)
    adv = port.make_audited_advance(scene, "pallas", spd, **KW, **CPU)
    assert adv.mode == ref_adv.mode == "cap8"
    capsys.readouterr()
    ref = ref_adv(rst)
    ref_err = capsys.readouterr().err
    ours = adv(ost)
    err = capsys.readouterr().err
    assert adv.mode == ref_adv.mode
    assert adv.healed == ref_adv.healed
    assert adv.repaired == ref_adv.repaired == 0
    return ref, ref_adv, ref_err, ours, adv, err


def _notes(err: str, prefix: str) -> list:
    """The policy's notes, without the package prefix."""
    return [ln[len(prefix):] for ln in err.splitlines()
            if ln.startswith(prefix)]


def _skin_of(err: str, prefix: str, full: float) -> str:
    """The skin a run chose, as its narrowing note prints it."""
    m = re.search(r"skin narrowed \S+ → (\S+) ", err)
    return m.group(1) if m else f"{full:.3g}"


def test_calm_scene_holds_cap8(capsys):
    rs, rst, scene, ost = _pair(small_scene(dim=2, seed=94))
    ref, ref_adv, ref_err, ours, adv, err = _both(capsys, rs, rst, scene, ost)
    assert adv.mode == "cap8" and adv.healed == 0
    assert "switching" not in ref_err + err
    full = port.default_skin(scene, 4)
    assert f"{adv.skin:.3g}" == _skin_of(ref_err, "sph_tpu: ", full)
    assert _notes(err, "sph_tpu_torch: ") == _notes(ref_err, "sph_tpu: ")
    _agree(ref, ours, "calm, cap 8")
    # cap 8 against the default cap: the same pair sets, other slot order
    wide, _ = port.make_advance(scene, "pallas", steps_per_dispatch=12,
                                sort_every=4, slot_resident=True, **CPU)(ost)
    assert np.allclose(ours.x.numpy(), wide.x.numpy(), rtol=1e-5, atol=1e-4)


def test_jet_switches_to_the_default_cap(capsys):
    rs, rst, scene, ost = _pair(_jet(small_scene(dim=2, seed=94)))
    ref, ref_adv, ref_err, ours, adv, err = _both(capsys, rs, rst, scene, ost)
    assert adv.mode == "cap16" and adv.healed == 3
    ref_notes = _notes(ref_err, "sph_tpu: ")
    assert _notes(err, "sph_tpu_torch: ") == ref_notes
    assert any("outgrown at step 0 (3/3 blocks healed)" in n
               for n in ref_notes)
    _agree(ref, ours, "jet, switched")
    # every block healed: the dispatch is the per-step run, bitwise
    exact = port.make_advance(scene, "pallas", steps_per_dispatch=12,
                              **CPU)(ost)
    _same(ours, exact)
    # the next dispatch runs the default cap
    ours2 = adv(ours)
    assert adv.mode == "cap16" and int(ours2.step) == 24


def test_skin_narrows_to_fit(capsys):
    """Nine static particles in ONE cell of the skin(4) lattice that
    straddle a cell boundary of the skin(2) lattice: the policy narrows
    the skin instead of healing every block."""
    rs, rst, _, _ = _pair(small_scene(dim=2, seed=94))
    s4 = ref_default_skin(rs, 4)
    g4 = ref_nb.GridSpec.for_scene(rs, cap=8, skin=s4)
    g2 = ref_nb.GridSpec.for_scene(rs, cap=8, skin=s4 / 2)
    lo4, lo2, c4 = float(g4.lo[0]), float(g2.lo[0]), g4.cell
    b2 = lo2 + 3 * g2.cell
    k4 = int(np.floor((b2 - lo4) / c4))
    assert lo4 + k4 * c4 + 0.5 < b2 < lo4 + (k4 + 1) * c4 - 0.5
    xs = np.asarray(rst.x).copy()
    kinds = np.asarray(rst.kind).copy()
    y = float(g4.lo[1]) + 350.0   # far corner, away from the fluid block
    for i in range(9):
        xs[i] = (b2 - 0.4 + 0.1 * i, y)
        kinds[i] = 1
    rst = RefState(**{**{f: getattr(rst, f) for f in
                         ("v", "acc", "rho", "p", "emit_step", "step")},
                      "x": jnp.asarray(xs), "kind": jnp.asarray(kinds)})
    rs, rst, scene, ost = _pair(rs, rst)
    ref, ref_adv, ref_err, ours, adv, err = _both(capsys, rs, rst, scene, ost)
    assert "narrowed" in ref_err and "narrowed" in err
    assert "switching" not in ref_err + err
    assert adv.mode == "cap8" and adv.skin < port.default_skin(scene, 4)
    assert f"{adv.skin:.3g}" == _skin_of(ref_err, "sph_tpu: ", s4)
    assert _notes(err, "sph_tpu_torch: ") == _notes(ref_err, "sph_tpu: ")
    assert int(ours.step) == 12 and bool(torch.isfinite(ours.x).all())
    _agree(ref, ours, "narrowed skin")
