"""PyTorch port, the constrained quadruped trot end to end on the CPU in
float64 (the port alone): the constrained example's single-robot sequence
(the offline `ALDDP.solve`, then 40 ticks of shift_warmstart and two
`solve_online`s at max_iters=1, walking at 0.15 m/s from tick 0), held to
the gates of the JAX package's `TestConstrainedTrot`
(tests/test_quadruped.py:218-263): the offline violation below 1e-3, the
largest violation over ticks 20-39 below 1e-2, a finite plan, the CoM
advanced by more than 0.15 m, and on every foot the cone rows F·A_fcᵀ
below 2 N and F_z above −2 N.
"""

import numpy as np
import pytest
import torch

from srbd_horizon_tpu_torch.config import SRBDConfig
from srbd_horizon_tpu_torch.problems.srbd import linearized_friction_cone_rows

from _torch_parity import (
    quadruped_al_solvers, quadruped_isrbd_problems, quadruped_trot_wpgs,
    torch_constrained_trot,
)

torch.set_num_threads(1)

TICKS = 40


@pytest.fixture(scope="module")
def trot():
    jp, tp = quadruped_isrbd_problems()
    _, off = quadruped_al_solvers(jp, tp, 15)
    _, on = quadruped_al_solvers(jp, tp, 1)
    _, wpg = quadruped_trot_wpgs(tp.ocp.ns)
    states = torch_constrained_trot(tp, off, on, wpg, TICKS)
    return dict(tp=tp, on=on, states=states)


def test_offline_solve_is_feasible(trot):
    assert float(trot["states"][0].viol) < 1e-3


def test_violation_stays_bounded_while_trotting(trot):
    viols = np.array([float(s.viol) for s in trot["states"][1:]])
    assert viols.shape == (TICKS,)
    assert viols[20:].max() < 1e-2, viols[20:].max()


def test_plan_is_finite_and_moves_forward(trot):
    st = trot["states"][-1]
    for t in (st.sol.X, st.sol.U, st.lam_eq, st.lam_eq_T):
        assert bool(torch.isfinite(t).all())
    progress = float(st.sol.X[0, 0] - trot["tp"].initial_state[0])
    assert progress > 0.15, progress


def test_friction_cones_hold_on_the_plan(trot):
    A = torch.as_tensor(linearized_friction_cone_rows(
        SRBDConfig().friction_cone_coefficient), dtype=torch.float64)
    d = trot["on"].solution_dict(trot["states"][-1])
    for i in range(4):
        F = d[f"f{i}"]
        assert float((F @ A.T).max()) < 2.0, i
        assert float(F[:, 2].min()) > -2.0, i
