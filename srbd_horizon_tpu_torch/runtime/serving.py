"""The constrained fleet-serving tick as the JAX package's serving
programs compose it (the `tick` of tools/bench_isrbd.py::measure and of
examples/serve_fleet.py --constrained): advance every member's gait
schedule, write the commanded CoM velocity into the horizon, take node 1
of the last plan as the measured state, and run
`ALDDP.serving_tick_batch` (shifted warm start, frozen-penalty outer
iterations, optional gait-phase multiplier priors)."""

from __future__ import annotations

import torch

from srbd_horizon_tpu_torch.solvers.alddp import ALDDP, ALState
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator, WPGState


def constrained_tick(online: ALDDP, wpg: WalkingPatternGenerator,
                     st: ALState, params, wpg_state: WPGState, action,
                     rdot_ref, prior=None, outers: int = 1,
                     prior_ema: float = 1.0):
    """One serving tick for the fleet. `action` (B,) int, `rdot_ref`
    (B, 3); every other argument leads with the fleet axis. The inner
    solves run `online.ddp_opts`' execution modes (under a non-default
    `riccati_mode` or `forward_pass`, JAX's `vmap(solve)` on K12/K13).
    Returns (ALState, params, WPGState, prior); `prior` is passed through
    as None when none is given."""
    period = 2 * wpg.step_nodes
    # cycle phase of this tick's terminal write (read before the advance)
    phase = wpg_state.step_counter % period
    p1, w1 = wpg.advance(params, wpg_state, action)
    ref = p1["rdot_ref"]
    p1["rdot_ref"] = torch.cat(
        [ref[:, :1], rdot_ref[:, None, :].expand(-1, ref.shape[1] - 1, -1)],
        dim=1)
    x0 = st.sol.X[:, 1]
    if prior is None:
        st = online.serving_tick_batch(st, x0, p1, outers=outers)
    else:
        st, prior = online.serving_tick_batch(
            st, x0, p1, outers=outers, prior=prior, phase=phase,
            prior_ema=prior_ema)
    return st, p1, w1, prior
