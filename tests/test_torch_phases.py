"""The port's training forward against the JAX package at one iteration in
each phase that the 140,000-iteration `train_magicpony_horse` run crosses
(`configs/model/magicpony.yaml`), on the CPU in float32:

    iteration  what it covers
    0          articulation off; naive pose probabilities
    3,000      past `naive_probs_iter` (the probabilities half naive)
    8,000      past `best_pose_start_iter` (the best hypothesis kept at 0.8)
    50,000     articulation on (`tests/test_torch_train.py`'s iteration)
    70,000     legs attached to the body; `arti_reg_loss` counts
    95,000     deformation (`netDeform`) and `deform_reg_loss`, coarse grid
    110,000    the fine grid

The grids are cut to 8 (coarse, `TINY_OVERRIDES`' grid) and 10 (fine), so
that the last phase really switches grids. Finer grids put more faces on
the silhouettes and self-occlusion edges, where the packages' float32
roundings flip a face: at grids 16 and 24, 1 to 5 pixels of every key
of the first 12 differ by 0.1 to 0.6, and no key passes the search.

Everything else is `tests/test_torch_train.py`'s: the models
(`TRAIN_OVERRIDES`, the fused netSDF sweep on both sides; one pair of
models serves every iteration), the dark batch, JAX's draws imposed as a
`Noise`, the key search of its `step` fixture (the first key whose
discrete decisions agree: feet, faces, antialias blend branches and,
where they matter, texture ReLU ties) and its tolerances: metrics and
loss within rtol 1e-4, each gradient leaf within `GRAD_TOL` (1e-3) of
its norm and the `NOISY_LEAVES` within `NOISY_TOL` (5e-3). See that file
for why each tolerance is what it is.

Which keys qualify depends on the last bit of float32 sums, hence on the
torch thread count. At 8 threads (the default on an 8-core machine) the
search takes keys 9 at 0, 3,000 and 8,000; 22 at 50,000; 20 at 70,000;
3 at 95,000 and 10 at 110,000, and every leaf passes. At 2 threads it
takes keys 1 at 95,000 and 16 at 110,000, whose netDeform, encoder and
articulation leaves read 1.03 to 1.17 tolerances with every decision
the same: keys one ulp from a decision, as keys 111 and 76 of
`test_torch_train.py` (`test_an_encoder_gap_is_as_large_as_a_one_ulp_nudge`).
"""
import numpy as np
import pytest

from test_torch_train import (Pair, gradient_gaps, leaf_tolerance,
                              search_steps)
from torch_parity import TRAIN_OVERRIDES, flat_tree, numpy_tree

COARSE, FINE = 8, 10
OVERRIDES = [o for o in TRAIN_OVERRIDES if "grid_res" not in o] + [
    f"model.cfg_predictor_base.cfg_shape.grid_res={FINE}",
    f"model.cfg_predictor_base.cfg_shape.grid_res_coarse={COARSE}"]

# iteration: (articulation_on, attach_legs, deform_on, use_coarse_grid)
PHASES = {
    0: (False, False, False, True),
    3000: (False, False, False, True),
    8000: (False, False, False, True),
    50000: (True, False, False, True),
    70000: (True, True, False, True),
    95000: (True, True, True, True),
    110000: (True, True, True, False),
}
ITERS = list(PHASES)


class Phases:
    """One `Pair` per iteration, all on one pair of models, and the
    search of each (`search_steps`: every iteration's in one child
    process, on the first call; a failed search is kept and fails
    again)."""

    def __init__(self):
        self.pairs, self.steps = {}, {}

    def pair(self, it):
        if it not in self.pairs:
            first = next(iter(self.pairs.values()), None)
            self.pairs[it] = Pair(it, OVERRIDES, models=first and (
                first.jm, first.jp, first.tm))
        return self.pairs[it]

    def step(self, it):
        if not self.steps:
            self.steps = search_steps({i: self.pair(i) for i in ITERS})
            for i, s in self.steps.items():
                print(s if isinstance(s, str)
                      else f"iteration {i}: key {s['seed']}")
        if isinstance(self.steps[it], str):
            pytest.fail(self.steps[it])
        return self.steps[it]


@pytest.fixture(scope="module")
def phases():
    return Phases()


@pytest.mark.parametrize("it", ITERS)
def test_phase_switches_match_jax(phases, it):
    """Both packages put the iteration in the phase of the table, and the
    fine phase really sweeps the finer grid."""
    pair = phases.pair(it)
    arti, attach, deform, coarse = PHASES[it]
    for phase in (pair.phase, pair.tphase):
        assert (phase.articulation_on, phase.attach_legs, phase.deform_on,
                phase.use_coarse_grid) == PHASES[it]
        assert phase.is_training
    assert tuple(pair.phase) == tuple(pair.tphase)
    jgrid, jv, jf = pair.jm.grid_for_phase(pair.phase)
    tgrid, tv, tf = pair.tm.grid_for_phase(pair.tphase)
    res = COARSE if coarse else FINE
    assert tgrid.res == jgrid.res == res
    assert (tv, tf) == (jv, jf)


@pytest.mark.parametrize("it", ITERS)
def test_phase_decisions_match_jax(phases, it):
    """The pose hypothesis, the random-pose flag and, where articulation
    is on, the articulation (within 1e-4)."""
    s = phases.step(it)
    jaux, taux = s["jaux"], s["taux"]
    np.testing.assert_array_equal(np.asarray(jaux["rot_idx"]),
                                  taux["rot_idx"].numpy())
    np.testing.assert_array_equal(np.asarray(jaux["rand_pose_flag"]),
                                  taux["rand_pose_flag"].numpy())
    if PHASES[it][0]:
        np.testing.assert_allclose(taux["arti_params"].detach().numpy(),
                                   np.asarray(jaux["arti_params"]),
                                   atol=1e-4)
    else:
        assert taux["arti_params"] is None and jaux["arti_params"] is None
    if PHASES[it][2]:
        np.testing.assert_allclose(taux["deformation"].detach().numpy(),
                                   np.asarray(jaux["deformation"]),
                                   atol=1e-5)


@pytest.mark.parametrize("it", ITERS)
def test_phase_loss_and_metrics_match_jax(phases, it):
    """Every metric and the total: rtol 1e-4; the metric set is the
    phase's (`arti_reg_loss` with articulation, `deform_reg_loss` with
    deformation)."""
    s = phases.step(it)
    assert set(s["tmet"]) == set(s["jmet"])
    assert ("arti_reg_loss" in s["tmet"]) == PHASES[it][0]
    assert ("deform_reg_loss" in s["tmet"]) == PHASES[it][2]
    for name, want in s["jmet"].items():
        np.testing.assert_allclose(float(s["tmet"][name].detach()),
                                   float(want), rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(s["tloss"]), float(s["jloss"]),
                               rtol=1e-4)


@pytest.mark.parametrize("it", ITERS)
def test_phase_gradient_tree_matches_jax(phases, it):
    """Every leaf the phase trains within its tolerance (`leaf_tolerance`);
    the leaves it does not use (netArticulation before 10,000, netDeform
    before 90,000) are zero in JAX's tree and absent from the port's;
    netDeform's leaves are compared from 90,000 on."""
    s = phases.step(it)
    gaps = gradient_gaps(flat_tree(s["tgrads"]),
                         flat_tree(numpy_tree(s["jgrads"])))
    trained = {p[1] for p in gaps}
    assert ("netArticulation" in trained) == PHASES[it][0]
    assert ("netDeform" in trained) == PHASES[it][2]
    assert len(gaps) > 20
    bad = {"/".join(p): g for p, g in gaps.items() if g > leaf_tolerance(p)}
    assert not bad, bad
