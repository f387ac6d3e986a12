"""PyTorch port, the JAX package's other execution modes at the point-feet
biped's SRBD problem under RK2 and RK4 (K1's `point_feet_rk` shape, which
the two steps share: every row of B live), in float64 on the CPU (the
kernels' plain twins), against the JAX package:

  - K12's twin at `point_feet_rk` with each gain solve against JAX's
    `_backward_associative` on its dense linearization of a drawn iterate
    (RK4, ns=8), entry by entry to 1e-9 of max(1, |JAX|); K1's Tassa twin
    with the Cholesky gains there against JAX's `_backward` with
    quu_solver="cholesky", to 1e-10;
  - K13's twin at the biped's RK2 and RK4 families against JAX's linear
    trial (`_forward_linear`, `_true_defects`, `total_cost`, the Armijo
    test) at 4 step sizes, from the iterate's merit and from one between
    the merits of α = 1/2 and 1/4: plans, costs and merits to 1e-9, the
    flags equal; the same twin with an Euler step in its true defects
    misses JAX's merits (JAX's `_true_defects` takes `ocp.step`);
  - the twins' dense A and B against JAX's dense jacfwd ones to 1e-12;
  - the dispatch: `MSDDP` builds under every mode and gain solve, and K13's
    family and K12's instantiations are the step's and the shape's rows.
"""

import functools

import pytest
import torch

from _torch_parity import (
    check_dense_dynamics, check_k1_cholesky, check_k12, check_k13,
    euler_defects_miss, modes_dispatch, modes_kernel_results,
)
from srbd_horizon_tpu_torch.kernels import linear_trial as k13
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels import riccati_associative as k12

torch.set_num_threads(1)

TOPOLOGY = "point_feet"
STEPS = ["RK2", "RK4"]
# K12's and K1's instantiations belong to K1's shape, which both steps
# share: held on the RK4 iterate; K13's families belong to each step
PARTS = {"RK2": ("k13",), "RK4": ("k12", "k1", "k13")}
FAMILY = {"RK2": 10, "RK4": 11}                      # FAMILIES indices


@functools.lru_cache(maxsize=None)
def _kernels(step):
    return modes_kernel_results(TOPOLOGY, step, parts=PARTS[step])


@pytest.mark.parametrize("quu_solver", ["schur", "cholesky"])
def test_k12_twin_matches_jax(quu_solver):
    res = _kernels("RK4")
    assert res["k1_shape"] == "point_feet_rk"
    check_k12(res, quu_solver)


def test_k1_tassa_cholesky_twin_matches_jax():
    check_k1_cholesky(_kernels("RK4"))
    assert k1.kernel_instance("point_feet_rk", "tassa", "cholesky") == 24


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
    name = f"point_feet_{step.lower()}"
    assert k13.FAMILIES[fam] == ("srbd", name, "point_feet_rk", name)
    assert k13.FAMILY_NAMES[fam] == f"point_feet_{step.lower()}"
    assert inst == {"schur": 14, "cholesky": 15}
    for sv, i in inst.items():
        assert k12.KERNEL_INSTANCES[i] == ("point_feet_rk", sv)
