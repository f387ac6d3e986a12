"""PyTorch port, the solves and ticks of the point-feet biped's SRBD problem
under RK2 and RK4, against the JAX package on the CPU in float64 at ns=8
(`_torch_parity.srbd_case` without its kernel part: one JAX compile a
step holding `solve`, `vmap(solve)` and the scanned `vmap(tick)`s):

  - `MSDDP.solve` against JAX's `solve` (its dense jacfwd linearization);
  - `MSDDP.solve_batch` at B=4 against JAX's `vmap(solve)`;
  - `MPCLoop.tick_batch` at B=4 (warm start shifted, mixed actions) against
    JAX's `vmap(tick)` for 3 ticks;

iterations and convergence equal, plans, x, u0 and cost to 1e-9.
"""

import functools

import pytest
import torch

from _torch_parity import check_srbd_solves, check_srbd_ticks, srbd_case

torch.set_num_threads(1)

TOPOLOGY = "point_feet"


@functools.lru_cache(maxsize=None)
def _case(step):
    """The solves and ticks of one step."""
    return srbd_case(TOPOLOGY, step, kernels=False)


@pytest.fixture(scope="module", params=["RK2", "RK4"])
def case(request):
    return _case(request.param)


def test_solve_matches_jax(case):
    check_srbd_solves(case, batched=False)


def test_solve_batch_matches_vmap_solve(case):
    check_srbd_solves(case, batched=True)


def test_tick_batch_matches_vmap_tick(case):
    check_srbd_ticks(case)
