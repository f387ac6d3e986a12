"""PyTorch port, the JAX package's other execution modes at the LIP problem
of the point-feet biped (`SRBDConfig(contact_model=1, number_of_legs=2)`,
`point_feet()`) under the Euler, RK2 and RK4 steps (K1's `lip_point_feet`
and `lip_point_feet_rk` shapes, nx = 18: K12's nx = 18 combine), in float64
on the CPU (the kernels' plain twins), against the JAX package at ns=8,
one JAX compile a step (`_torch_parity.lip_modes_results`):

  - K12's twin at each of the two shapes with each gain solve against
    JAX's `_backward_associative` on its dense linearization of a drawn
    iterate, entry by entry to 1e-9 of max(1, |JAX|);
  - K13's twin at the three families against JAX's linear trial
    (`_forward_linear`, `_true_defects`, `total_cost`, the Armijo test) at
    4 step sizes, from the iterate's merit and from one between the merits
    of α = 1/2 and 1/4: plans, costs and merits to 1e-9, the flags equal;
    under RK2 and RK4 the same twin with an Euler step in its true defects
    misses JAX's merits;
  - the LIP's step is affine, so K13's twin makes K11's (the rollout
    trial's) plans, costs and merits, to 1e-9 relative;
  - `MSDDP.solve` and `solve_batch` (B=4) under associative/linear against
    JAX's `solve` and `vmap(solve)`, and 3 ticks of `tick_batch` of
    `build_lip_loop` against JAX's `vmap(tick)`, with max_iters=1 to 1e-9
    and with the solver's options by F8's floor rule (Cholesky gains under
    Euler and RK4, block-Schur under RK2), one K12 sweep an iteration and
    K13 on the trials; under Euler also associative/nonlinear (the solves
    and the max_iters=1 ticks);
  - the dispatch: `MSDDP` builds under every mode and gain solve, and
    K13's family and K12's instantiations are the step's and the shape's
    rows.
"""

import functools

import pytest
import torch

from _torch_parity import (
    MODES, check_k12, check_k13, check_k13_is_k11, check_lip_mode_runs,
    euler_defects_miss, lip_modes_dispatch, lip_modes_results,
)
from srbd_horizon_tpu_torch.kernels import linear_trial as k13
from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

torch.set_num_threads(1)

TOPOLOGY = "point_feet"
STEPS = ["EULER", "RK2", "RK4"]
# K12's instantiations belong to K1's shape, which RK2 and RK4 share: held
# on the Euler and RK4 iterates; K13's families belong to each step
PARTS = {"EULER": ("k12", "k13"), "RK2": ("k13",), "RK4": ("k12", "k13")}
GAINS = {"EULER": "cholesky", "RK2": "schur", "RK4": "cholesky"}
SINGLE = {"EULER": MODES[0]}                         # associative/nonlinear
FAMILY = {"EULER": 13, "RK2": 18, "RK4": 19}         # FAMILIES indices
SHAPE = {"EULER": "lip_point_feet", "RK2": "lip_point_feet_rk",
         "RK4": "lip_point_feet_rk"}
INSTANCES = {"lip_point_feet": (22, 23), "lip_point_feet_rk": (24, 25)}


@functools.lru_cache(maxsize=None)
def _results(step):
    return lip_modes_results(TOPOLOGY, step, GAINS[step], parts=PARTS[step],
                             single=SINGLE.get(step))


@pytest.mark.parametrize("quu_solver", ["schur", "cholesky"])
@pytest.mark.parametrize("step", ["EULER", "RK4"])
def test_k12_twin_matches_jax(step, quu_solver):
    res = _results(step)
    assert res["k1_shape"] == SHAPE[step]
    check_k12(res, quu_solver)


@pytest.mark.parametrize("merit0", ["iterate", "mid"])
@pytest.mark.parametrize("step", STEPS)
def test_k13_twin_matches_jax(step, merit0):
    check_k13(_results(step), merit0)


@pytest.mark.parametrize("step", ["RK2", "RK4"])
def test_k13_defects_take_the_rk_step(step, monkeypatch):
    merit_gap, defect_gap = euler_defects_miss(_results(step), monkeypatch)
    assert merit_gap > 1e-9 and defect_gap > 1e-3, (merit_gap, defect_gap)


@pytest.mark.parametrize("step", STEPS)
def test_k13_twin_is_the_rollout(step):
    check_k13_is_k11(_results(step))


@pytest.mark.parametrize("part", ["solves", "exact_step", "options"])
@pytest.mark.parametrize("step", STEPS)
def test_mode_runs_match_jax(step, part):
    check_lip_mode_runs(_results(step), part)


@pytest.mark.parametrize("step", [s for s in STEPS if s in SINGLE])
@pytest.mark.parametrize("part", ["solves", "exact_step"])
def test_single_mode_runs_match_jax(step, part):
    check_lip_mode_runs(_results(step), part, single=True)


@pytest.mark.parametrize("step", STEPS)
def test_modes_build_and_dispatch(step):
    fam, inst = lip_modes_dispatch(TOPOLOGY, step)
    assert fam == FAMILY[step]
    lin = TOPOLOGY + ("" if step == "EULER" else "_" + step.lower())
    assert k13.FAMILIES[fam] == ("lip", lin, SHAPE[step], "lip_" + lin)
    assert inst == dict(zip(("schur", "cholesky"), INSTANCES[SHAPE[step]]))
    for sv, i in inst.items():
        assert k12.KERNEL_INSTANCES[i] == (SHAPE[step], sv)
