"""PyTorch port, the AL solver under the JAX package's other execution
modes on the point-feet quadruped's isrbd problem (K12 and K13 at the
quadruped's AL shape, `isrbd_al_quadruped`), in float64 on the CPU (the
kernels' plain twins), at ns=8 against the JAX package with the same
options (tests/test_torch_modes_alddp.py runs the Kangaroo's):

- `ALDDP.solve` (2 outers × 3 inner iterations from ρ₀ 1e3, the static
  input tiled), then the warm start shifted and two `solve_online`s with
  rdot_ref (0.15, 0, 0), under each of the three non-default combinations:
  iterations and convergence equal; X, U, cost, multipliers, ρ and the
  violation to 1e-9; one K12 sweep an inner iteration under the
  associative sweep and K1 none, K13 on the linear trials only;
- every combination reaches the solution of the default modes.
"""

import pytest
import torch

from _torch_parity import (
    MODE_IDS, MODES, QUAD_VX, al_agree, max_rel_err, quadruped_isrbd_problems,
    run_al_modes,
)

torch.set_num_threads(1)

NS = 8


@pytest.fixture(scope="module")
def quadruped():
    jp, tp = quadruped_isrbd_problems(ns=NS)
    out = {mode: run_al_modes(jp, tp, mode, vx=QUAD_VX) for mode in MODES}
    out["default"] = run_al_modes(jp, tp, ("sequential", "nonlinear"),
                                  jax_side=False, vx=QUAD_VX)
    return out


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_quadruped_alddp_solve_and_online_match_jax(quadruped, mode):
    want, got, spy = quadruped[mode]
    for name, g, w in zip(("offline solve", "online 1", "online 2"), got, want):
        al_agree(g, w, f"{mode} {name}")
    spy.check(mode)
    assert float(got[0].viol) < 1e-1


def test_quadruped_modes_reach_the_default_modes_solution(quadruped):
    ref = quadruped["default"][1]
    for mode in MODES:
        for g, w in zip(quadruped[mode][1], ref):
            assert int(g.sol.iterations) == int(w.sol.iterations), mode
            assert max_rel_err(g.sol.cost, w.sol.cost) < 1e-9, mode
            assert max_rel_err(g.sol.X, w.sol.X) < 1e-6, mode
            assert max_rel_err(g.viol, w.viol) < 1e-6, mode
