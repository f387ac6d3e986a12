"""PyTorch port, the line-feet quadruped's SRBD problem (contact_model=2
on four legs: two contact points a foot, nc=8, nx=61, nu=48; JAX's
`TestLineFeetQuadruped` robot) under the Euler step, against the JAX
package on the CPU in float64 at ns=8 (`_torch_parity.srbd_case`: one JAX
compile a step):

  - the step, the stage residual, the equality rows and the terminal
    residual at drawn points (the step to 1e-13, the rest to 1e-12) —
    among them the foot-pair tracking rows, which pair c0 with c2 and c1
    with c7 on this robot, and the relative-velocity rows of four legs;
  - the declared rows exact at drawn points (every nonzero inside, every
    declared row live), Euler's declarations JAX's;
  - the K4 twin against JAX's dense `jacfwd` linearization, the K3 twin
    (1 and 4 step sizes, a NaN start) and the srbd_evaluate twin (a NaN
    in a plan, plain and pinned) against JAX's trial, `total_cost` and
    `_true_defects`, to 1e-12;
  - `MSDDP.solve` and `solve_batch` (B=4, pushes of 0.02) against JAX's
    `solve` and `vmap(solve)`, and 3 `tick_batch` ticks of the trot
    (the 8-entry mask) against JAX's `vmap(tick)`: iterations equal,
    plans, x, u0 and cost to 1e-9;
  - JAX's `TestLineFeetQuadruped` bar on the port's standing solve
    (converged, defects below 1e-6, Σ F_z within 1% of m·g/fs);
  - the dispatch: K4, K3, srbd_evaluate and K1 pick the line-feet
    quadruped's own instance, K1's in the line-feet library.
"""

import functools

import pytest
import torch

from _torch_parity import (
    LINE_FEET_OPTS, SRBD_ORDER, check_line_feet_bar, check_srbd_declared_rows,
    check_srbd_dispatch, check_srbd_evaluate, check_srbd_linearize,
    check_srbd_node_functions, check_srbd_solves, check_srbd_ticks,
    check_srbd_trial, srbd_case, srbd_problems,
)
from srbd_horizon_tpu_torch.config import DDPOptions
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

TOPOLOGY = "line_feet_quadruped"
STEPS = ("EULER",)


@functools.lru_cache(maxsize=None)
def _case(step):
    return srbd_case(TOPOLOGY, step)


@pytest.fixture(scope="module", params=STEPS)
def case(request):
    return _case(request.param)


def test_problem_sizes(case):
    tp = case["tp"]
    assert (tp.ocp.nx, tp.ocp.nu, tp.nc) == (61, 48, 8)
    assert tp.ocp.constants["terms"].n_rho == 125


def test_node_functions_match_jax(case):
    check_srbd_node_functions(case)


@pytest.mark.parametrize("seed", [35, 36])
def test_declared_rows_are_exact(case, seed):
    check_srbd_declared_rows(case, seed)


@pytest.mark.parametrize("key", SRBD_ORDER)
def test_linearize_twin_matches_jax_dense(case, key):
    check_srbd_linearize(case, key)


@pytest.mark.parametrize("nA", [1, 4])
def test_trial_twin_matches_jax(case, nA):
    check_srbd_trial(case, nA)


@pytest.mark.parametrize("pin", [False, True], ids=["plan", "pinned"])
def test_evaluate_twin_matches_jax(case, pin):
    check_srbd_evaluate(case, pin)


def test_kernel_shapes_pick_the_instance(case):
    check_srbd_dispatch(case, "line_feet_quadruped", "line_feet_quadruped",
                        "riccati_backward_line_feet")


def test_solve_matches_jax(case):
    check_srbd_solves(case, batched=False)


def test_solve_batch_matches_vmap_solve(case):
    check_srbd_solves(case, batched=True)


def test_tick_batch_matches_vmap_tick(case):
    check_srbd_ticks(case)


@pytest.mark.parametrize("step", STEPS)
def test_standing_solve_meets_jaxs_bar(step):
    """JAX's TestLineFeetQuadruped solve (max_iters=20,
    alpha_converge_threshold=1e-12, beta=1e-3, from the nominal state) on
    the port, under this step, at the default horizon."""
    _, tp = srbd_problems(TOPOLOGY, step)
    s = MSDDP(tp.ocp, DDPOptions(**LINE_FEET_OPTS))
    x0 = tp.initial_state
    sol = s.solve(s.init(x0), x0, tp.ocp.params)
    check_line_feet_bar(tp, sol)
