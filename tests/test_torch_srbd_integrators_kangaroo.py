"""PyTorch port, the solves and ticks of the Kangaroo's (line feet) SRBD problem
under RK2 and RK4, against the JAX package on the CPU in float64 at ns=8
(`_torch_parity.solve_results`, `tick_results`):

  - `MSDDP.solve` against JAX's `solve` (its dense jacfwd linearization);
  - `MSDDP.solve_batch` at B=4 against JAX's `vmap(solve)`;
  - `MPCLoop.tick_batch` at B=4 (warm start shifted, mixed actions) against
    JAX's `vmap(tick)` for 3 ticks;

iterations and convergence equal, plans, x, u0 and cost to 1e-9.
`test_jax_batched_rk_uses_euler_rows` pins a fault of the JAX package
(ROADMAP Queue 3, F10): its batched path reads only the rows of B its
`build_srbd_problem` declares, Euler's, under RK2 too.
"""

import functools

import pytest
import torch

from _torch_parity import agree, max_rel_err, solve_results, tick_results

torch.set_num_threads(1)

TOPOLOGY = "kangaroo"


@functools.lru_cache(maxsize=None)
def _solves(step):
    """The solves of one step; under RK2 JAX's `solve_batch` too, for F10."""
    return solve_results(TOPOLOGY, step, jax_solve_batch=step == "RK2")


@pytest.fixture(scope="module", params=["RK2", "RK4"])
def solves(request):
    return request.param, _solves(request.param)


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


def test_jax_batched_rk_uses_euler_rows():
    """F10 (ROADMAP Queue 3, reference side): JAX's `build_srbd_problem`
    declares Euler's rows of B (ṙ, ω, ċ) under RK2 and RK4 too, and its
    batched path (`solve_batch`, `tick_batch`) reads only the declared
    rows, so its plans part from its own `vmap(solve)` by more than 1e-3 in
    U, while the port, which declares every row, matches `vmap(solve)` to
    1e-9 (B=4, ns=8, RK2). This test fails once the JAX side declares the
    RK rows; F10 then closes."""
    step, s = "RK2", _solves("RK2")
    jax_gap = max_rel_err(s["jax_solve_batch"].U, s["jax_vmap_solve"].U)
    port_gap = max_rel_err(s["solve_batch"].U, s["jax_vmap_solve"].U)
    assert jax_gap > 1e-3, (step, jax_gap)
    assert port_gap < 1e-9, (step, port_gap)
