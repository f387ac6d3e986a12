"""PyTorch port, the JAX package's other execution modes at the Kangaroo's
SRBD problem (line feet) under RK2 and RK4 (K1's `srbd_rk` shape, which
the two steps share: every row of B live), in float64 on the CPU (the
kernels' plain twins), against the JAX package:

  - K12's twin at `srbd_rk` with each gain solve against JAX's
    `_backward_associative` on its dense linearization of a drawn iterate
    (RK4, ns=8), entry by entry to 1e-9 of max(1, |JAX|);
  - K13's twin at the Kangaroo's RK2 and RK4 families against JAX's linear
    trial (`_forward_linear`, `_true_defects`, `total_cost`, the Armijo
    test) at 4 step sizes, from the iterate's merit and from one between
    the merits of α = 1/2 and 1/4: plans, costs and merits to 1e-9, the
    flags equal; the same twin with an Euler step in its true defects
    misses JAX's merits (JAX's `_true_defects` takes `ocp.step`);
  - the twins' dense A and B against JAX's dense jacfwd ones to 1e-12;
  - the dispatch: `MSDDP` builds under every mode and gain solve, and K13's
    family and K12's instantiations are the step's and the shape's rows;
  - RK4 with the Cholesky gains under associative/linear: `MSDDP.solve`
    against JAX's `solve` and `solve_batch` at B=4 against JAX's
    `solve_batch` (`vmap(solve)` under a mode, which F10 does not reach):
    iterations and convergence equal, plans and cost to 1e-9, the final
    defects to 1e-12, one K12 sweep an iteration, K13 on the trials.
"""

import functools

import pytest
import torch

from _torch_parity import (
    check_dense_dynamics, check_k12, check_k13, check_mode_solves,
    euler_defects_miss, modes, modes_dispatch, modes_kernel_results,
    solve_results,
)
from srbd_horizon_tpu_torch.kernels import linear_trial as k13
from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

torch.set_num_threads(1)

TOPOLOGY = "kangaroo"
STEPS = ["RK2", "RK4"]
# K12's instantiations belong to K1's shape, which both steps share: held
# on the RK4 iterate; K13's families belong to each step
PARTS = {"RK2": ("k13",), "RK4": ("k12", "k13")}
FAMILY = {"RK2": 6, "RK4": 7}                        # FAMILIES indices
LINEAR = ("associative", "linear")


@functools.lru_cache(maxsize=None)
def _kernels(step):
    return modes_kernel_results(TOPOLOGY, step, parts=PARTS[step])


@functools.lru_cache(maxsize=None)
def _solves():
    return solve_results(TOPOLOGY, "RK4", quu_solver="cholesky",
                         **modes(*LINEAR))


@pytest.mark.parametrize("quu_solver", ["schur", "cholesky"])
def test_k12_twin_matches_jax(quu_solver):
    res = _kernels("RK4")
    assert res["k1_shape"] == "srbd_rk"
    check_k12(res, quu_solver)


@pytest.mark.parametrize("merit0", ["iterate", "mid"])
@pytest.mark.parametrize("step", STEPS)
def test_k13_twin_matches_jax(step, merit0):
    check_k13(_kernels(step), merit0)


@pytest.mark.parametrize("step", STEPS)
def test_k13_defects_take_the_rk_step(step, monkeypatch):
    merit_gap, defect_gap = euler_defects_miss(_kernels(step), monkeypatch)
    assert merit_gap > 1e-9 and defect_gap > 1e-3, (merit_gap, defect_gap)


@pytest.mark.parametrize("step", STEPS)
def test_dense_dynamics_match_jax(step):
    check_dense_dynamics(_kernels(step))


@pytest.mark.parametrize("step", STEPS)
def test_modes_build_and_dispatch(step):
    fam, inst = modes_dispatch(TOPOLOGY, step)
    assert fam == FAMILY[step]
    name = f"kangaroo_{step.lower()}"
    assert k13.FAMILIES[fam] == ("srbd", name, "srbd_rk", name)
    assert k13.FAMILY_NAMES[fam] == f"kangaroo_{step.lower()}"
    assert inst == {"schur": 10, "cholesky": 11}
    for sv, i in inst.items():
        assert k12.KERNEL_INSTANCES[i] == ("srbd_rk", sv)


def test_rk4_cholesky_solves_match_jax_under_the_modes():
    s = _solves()
    check_mode_solves(s, LINEAR)
    assert int(s["solve"].iterations) > 2
