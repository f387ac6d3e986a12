"""PyTorch port, the JAX package's other execution modes at the point-feet
biped (`point_feet()`, SRBD, Euler: nx=25, nu=12), in float64 on the CPU
(the kernels' plain twins), against the JAX package:

  - K12's twin (`riccati_associative_plain`) at K1's `point_feet` shape,
    with each gain solve, against JAX's `_backward_associative` on its
    dense linearization of the same drawn iterate (ns=8), entry by entry
    to 1e-9 of max(1, |JAX|); K13's twin (`linear_trial_plain`, the
    point-feet family) against JAX's linear trial (`_forward_linear`,
    `_true_defects`, `total_cost`, the Armijo test) at 4 step sizes, from
    the iterate's merit and from one between the merits of α = 1/2 and 1/4:
    plans, costs and merits to 1e-9, the flags equal;
  - `MSDDP.solve` under associative/linear against JAX's `solve`, and
    `solve_batch` at B=4 against JAX's `solve_batch` (`vmap(solve)` under
    a mode): iterations and convergence equal, plans and cost to 1e-9, the
    final defects to 1e-12, one K12 sweep an iteration, K13 on the trials;
  - the dispatch: `MSDDP` builds under every mode and gain solve, and
    `family_index` and `shape_instance` find the new rows;
  - F11 (ROADMAP Queue 3, reference side): both packages' isrbd builders
    refuse this robot with an IndexError (`fpi[2]` of a two-entry list).
"""

import functools

import numpy as np
import pytest
import torch

from _torch_parity import (
    check_k12, check_k13, check_mode_solves, modes, modes_dispatch,
    modes_kernel_results, solve_results,
)
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig
from srbd_horizon_tpu.models.kangaroo import point_feet as j_point_feet
from srbd_horizon_tpu.problems.isrbd import build_isrbd_problem as j_isrbd
from srbd_horizon_tpu_torch.config import SRBDConfig
from srbd_horizon_tpu_torch.kernels import linear_trial as k13
from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
from srbd_horizon_tpu_torch.models.kangaroo import point_feet
from srbd_horizon_tpu_torch.problems.isrbd import build_isrbd_problem

torch.set_num_threads(1)

LINEAR = ("associative", "linear")


@pytest.fixture(scope="module")
def kernels():
    return modes_kernel_results("point_feet", "EULER", parts=("k12", "k13"))


@functools.lru_cache(maxsize=None)
def _solves():
    return solve_results("point_feet", "EULER", **modes(*LINEAR))


@pytest.mark.parametrize("quu_solver", ["schur", "cholesky"])
def test_k12_twin_matches_jax(kernels, quu_solver):
    assert kernels["k1_shape"] == "point_feet"
    check_k12(kernels, quu_solver)


@pytest.mark.parametrize("merit0", ["iterate", "mid"])
def test_k13_twin_matches_jax(kernels, merit0):
    check_k13(kernels, merit0)


def test_k13_flags_take_both_values(kernels):
    """From the mid merit the larger steps pass the Armijo test and the
    smaller fail it, so the flags' comparison holds the rule both ways."""
    mid = np.asarray(kernels["k13", "mid"][0][4])
    assert mid.any() and not mid.all()


def test_solve_matches_jax_under_the_modes():
    s = _solves()
    check_mode_solves(s, LINEAR)
    assert int(s["solve"].iterations) > 2


def test_modes_build_and_dispatch():
    """Every mode and gain solve builds at the point-feet biped, and the
    kernels' tables name its rows: K13's point-feet family (index 5), K12's
    `point_feet` instantiations (8, 9)."""
    fam, inst = modes_dispatch("point_feet", "EULER")
    assert (fam, k13.FAMILY_NAMES[fam]) == (5, "point_feet")
    assert k13.FAMILIES[fam] == ("srbd",) + ("point_feet",) * 3
    assert inst == {"schur": 8, "cholesky": 9}
    for sv, i in inst.items():
        assert k12.KERNEL_INSTANCES[i] == ("point_feet", sv)


def test_isrbd_builders_refuse_the_point_feet_biped():
    """F11: JAX's `build_isrbd_problem` reads `fpi[2]` of the two-entry
    foot-pair list of a two-leg point-feet robot and raises IndexError;
    the port's builder raises the same. This test fails once the JAX
    side takes the robot (or names its refusal otherwise)."""
    import jax.numpy as jnp

    topo = dict(contact_model=1, number_of_legs=2)
    with pytest.raises(IndexError):
        j_isrbd(JSRBDConfig(dtype=jnp.float64, **topo), j_point_feet())
    with pytest.raises(IndexError):
        build_isrbd_problem(SRBDConfig(dtype=torch.float64, **topo),
                            point_feet(), device="cpu")
