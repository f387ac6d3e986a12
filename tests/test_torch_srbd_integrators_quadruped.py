"""PyTorch port, the solves and ticks of the point-feet quadruped's SRBD
problem under RK2 and RK4, against the JAX package on the CPU in float64 at ns=8
(`_torch_parity.solve_results`, `tick_results`):

  - `MSDDP.solve` against JAX's `solve` (its dense jacfwd linearization);
  - `MSDDP.solve_batch` at B=4 against JAX's `vmap(solve)`;
  - `MPCLoop.tick_batch` at B=4 (warm start shifted, mixed actions) against
    JAX's `vmap(tick)` for 3 ticks;

iterations and convergence equal, plans, x, u0 and cost to 1e-9.
"""

import pytest
import torch

from _torch_parity import agree, max_rel_err, solve_results, tick_results

torch.set_num_threads(1)

TOPOLOGY = "quadruped"


@pytest.fixture(scope="module", params=["RK2", "RK4"])
def solves(request):
    return request.param, solve_results(TOPOLOGY, request.param)


def test_solve_matches_jax(solves):
    step, s = solves
    agree(s["solve"], s["jax_solve"], f"{step} solve", ("X", "U", "cost"))
    assert int(s["solve"].iterations) > 1


def test_solve_batch_matches_vmap_solve(solves):
    step, s = solves
    agree(s["solve_batch"], s["jax_vmap_solve"], f"{step} solve_batch",
          ("X", "U", "cost"))
    assert float(s["solve_batch"].defect_norm.max()) < 1e-6


@pytest.mark.parametrize("step", ["RK2", "RK4"])
def test_tick_batch_matches_vmap_tick(step):
    for i, ((tc, to), (jc, jo)) in enumerate(tick_results(TOPOLOGY, step)):
        agree(to, jo, f"{step} tick {i}", ("x", "u0", "cost"))
        for f in ("X", "U"):
            assert max_rel_err(getattr(tc.sol, f), getattr(jc.sol, f)) < 1e-9
