"""PyTorch port, the LIP problem of the line-feet quadruped (contact_model=2
on four legs: two contact points a foot, nc=8, nx=54, nu=27; JAX's
`TestLineFeetQuadruped` robot) under the Euler step, against the JAX
package's `build_lip_problem(..., integrator=...)` on the CPU in float64
at ns=8, one JAX compile a step (`_torch_parity.lip_results`):

  - the build, the step, ρ and the terminal residual to 1e-12 (among ρ's
    rows the foot pairs of the rel rows, c0 with c2 and c1 with c7 here,
    and the relative-velocity rows of four legs);
  - the declared rows exact (every nonzero inside, every declared row
    live), with every row of B live under RK;
  - the K10, K11 (1 and 4 step sizes, a NaN start) and lip_evaluate (a NaN
    in a plan; plain and pinned) twins against JAX's dense `jacfwd`,
    `_rollout` with the Armijo test, `total_cost` and `_true_defects`, to
    1e-12;
  - `MSDDP.solve` and `solve_batch` (B=4) against JAX's `solve` and
    `vmap(solve)`: iterations equal, costs to 1e-9, the single solve's
    plans to 1e-9 and the batched plans to the merit's floor (F8);
  - `build_lip_loop(integrator=...)` with the trot's 8-entry mask for 3
    ticks of `tick_batch` against JAX's `vmap(tick)`: with max_iters=1 (the
    exact step) to 1e-9, with the solver's options by F8's floor rule;
  - the kernels' dispatch: K10, K11, lip_evaluate and K1 pick this step's
    line-feet instance, K1's in the line-feet library.
"""

import functools

import pytest
import torch

from _torch_parity import (
    SWEEP_ORDER, check_lip_evaluate, check_lip_linearize, check_lip_nodes,
    check_lip_rows, check_lip_solves, check_lip_ticks, check_lip_trial,
    lip_results,
)
from srbd_horizon_tpu_torch.kernels import lip_linearize as k10
from srbd_horizon_tpu_torch.kernels import riccati as k1

torch.set_num_threads(1)

TOPOLOGY = "line_feet_quadruped"
STEPS = ("EULER",)


@functools.lru_cache(maxsize=None)
def _results(step):
    return lip_results(TOPOLOGY, step)


@pytest.fixture(scope="module", params=STEPS)
def res(request):
    return _results(request.param)


def test_build_and_node_functions_match_jax(res):
    assert (res["tp"].ocp.nx, res["tp"].ocp.nu, res["tp"].nc) == (54, 27, 8)
    assert res["ts"].terms.n_rho == 72
    check_lip_nodes(res)


def test_declared_rows_are_exact(res):
    check_lip_rows(res)


@pytest.mark.parametrize("key", SWEEP_ORDER)
def test_linearize_twin_matches_jax_dense(res, key):
    check_lip_linearize(res, key)


@pytest.mark.parametrize("nA", [1, 4])
def test_trial_twin_matches_jax(res, nA):
    check_lip_trial(res, nA)


@pytest.mark.parametrize("pinned", [False, True], ids=["plan", "pinned"])
def test_evaluate_twin_matches_jax(res, pinned):
    check_lip_evaluate(res, pinned)


def test_solves_match_jax(res):
    check_lip_solves(res)


@pytest.mark.parametrize("exact", [False, True],
                         ids=["options", "exact_step"])
def test_tick_batch_matches_vmap_tick(res, exact):
    check_lip_ticks(res, exact)


def test_kernel_shapes_pick_the_instance(res):
    """K10's, K11's and lip_evaluate's check name the line-feet quadruped
    under this step, K1 its LIP shape (RK2 and RK4 share one; n_gx alone
    tells it from the other eight-contact robot's) with all three forms,
    built in the line-feet library."""
    ts, ocp = res["ts"], res["tp"].ocp
    step = ts.terms.step
    want = TOPOLOGY + ("" if step == "EULER" else "_" + step.lower())
    for name in ("lip_linearize", "lip_trial", "lip_evaluate"):
        assert k10.check_kernel_shape(name, ts.terms, ocp.nx, ocp.nu,
                                      ts.rows) == want
    shape = k1.kernel_shape(ocp.nx, ocp.nu, 10, ts.rows)
    assert shape == "lip_" + TOPOLOGY + ("" if step == "EULER" else "_rk")
    for form, solver in (("collapsed", "schur"), ("tassa", "schur"),
                         ("tassa", "cholesky")):
        inst = k1.kernel_instance(shape, form, solver)
        assert k1.KERNEL_INSTANCES[inst] == (shape, form, solver)
        assert k1.library_name(inst) == "riccati_backward_line_feet"
