"""PyTorch port, the solves and ticks of the Kangaroo's (line feet) SRBD problem
under RK2 and RK4, against the JAX package on the CPU in float64 at ns=8
(`_torch_parity.srbd_case` without its kernel part: one JAX compile a
step holding `solve`, `vmap(solve)` and the scanned `vmap(tick)`s):

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

from _torch_parity import (check_srbd_solves, check_srbd_ticks, max_rel_err,
                           srbd_case)

torch.set_num_threads(1)

TOPOLOGY = "kangaroo"


@functools.lru_cache(maxsize=None)
def _case(step):
    """The solves and ticks of one step; under RK2 JAX's `solve_batch`
    too, for F10."""
    return srbd_case(TOPOLOGY, step, kernels=False,
                     jax_solve_batch=step == "RK2")


@pytest.fixture(scope="module", params=["RK2", "RK4"])
def case(request):
    return _case(request.param)


def test_solve_matches_jax(case):
    check_srbd_solves(case, batched=False)


def test_solve_batch_matches_vmap_solve(case):
    check_srbd_solves(case, batched=True)


def test_tick_batch_matches_vmap_tick(case):
    check_srbd_ticks(case)


def test_jax_batched_rk_uses_euler_rows():
    """F10 (ROADMAP Queue 3, reference side): JAX's `build_srbd_problem`
    declares Euler's rows of B (ṙ, ω, ċ) under RK2 and RK4 too, and its
    batched path (`solve_batch`, `tick_batch`) reads only the declared
    rows, so its plans part from its own `vmap(solve)` by more than 1e-3 in
    U, while the port, which declares every row, matches `vmap(solve)` to
    1e-9 (B=4, ns=8, RK2). This test fails once the JAX side declares the
    RK rows; F10 then closes."""
    step, c = "RK2", _case("RK2")
    j = c["jax"]
    jax_gap = max_rel_err(j["solve_batch"].U, j["vmap_solve"].U)
    port_gap = max_rel_err(c["port"]["solve_batch"].U, j["vmap_solve"].U)
    assert jax_gap > 1e-3, (step, jax_gap)
    assert port_gap < 1e-9, (step, port_gap)
