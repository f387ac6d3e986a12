"""The JAX package's constrained serving fleet under an execution mode, on
the CPU: the violation trace the port's `chip_smoke.py` fleets are read
against. Not collected by pytest (a B=256 run takes minutes); run by hand:

    JAX_PLATFORMS=cpu python tests/modes_fleet_reference.py \\
        kangaroo f32 associative linear 256

`robot` kangaroo: `build_isrbd_problem(..., cz_rho_weight=3200)`, the
round-5 serving point (1 outer × 1 inner iteration, walking with rdot_ref
(0.1, 0, 0) from tick 0); quadruped: the point-feet quadruped's problem
(2 outers, the trot WPG, standing, then (0.15, 0, 0) from tick 10). Both
seeded by the batched offline solve (`al_serving_options(15)`, the same
mode) from x0 = nominal + 0.01·N(0,1) (seed 11), a `FullPhasePrior` at EMA
1, 81 ticks. Prints the largest violation of each 10 ticks and of ticks
61-80 (`window_viol_max`, phase 13's window), and the seconds taken.
"""

import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
if sys.argv[2] == "f64":
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from srbd_horizon_tpu.config import SRBDConfig  # noqa: E402
from srbd_horizon_tpu.models.kangaroo import kangaroo_line_feet  # noqa: E402
from srbd_horizon_tpu.models.quadruped import (  # noqa: E402
    quadruped_point_feet,
    trot_group_mask,
)
from srbd_horizon_tpu.problems.isrbd import build_isrbd_problem  # noqa: E402
from srbd_horizon_tpu.solvers.alddp import ALDDP  # noqa: E402
from srbd_horizon_tpu.solvers.options import al_serving_options  # noqa: E402
from srbd_horizon_tpu.wpg import WalkingPatternGenerator  # noqa: E402

TICKS = 81


def main(robot, dt, riccati_mode, forward_pass, B):
    dtype = jnp.float32 if dt == "f32" else jnp.float64
    modes = dict(riccati_mode=riccati_mode, forward_pass=forward_pass)
    quad = robot == "quadruped"

    def solver(max_iters):
        d, a = al_serving_options(max_iters)
        if quad:
            r = quadruped_point_feet()
            prob = build_isrbd_problem(
                SRBDConfig(dtype=dtype, contact_model=1, number_of_legs=4,
                           lip_height=float(r.com[2])), r)
        else:
            prob = build_isrbd_problem(SRBDConfig(dtype=dtype),
                                       kangaroo_line_feet(),
                                       cz_rho_weight=3200.0)
        return prob, ALDDP(prob.ocp, dataclasses.replace(d, **modes), a)

    prob, off = solver(15)
    _, on = solver(1)
    ns, nx = prob.ocp.ns, prob.ocp.nx
    topo = dict(group_mask=trot_group_mask(), contact_model=1,
                number_of_legs=4) if quad else {}
    wpg = WalkingPatternGenerator.build(0.0, ns, dtype=dtype, **topo)
    g = np.random.RandomState(11)
    x0 = jnp.asarray(np.asarray(prob.initial_state)[None]
                     + 0.01 * g.randn(B, nx), dtype)
    params = {k: jnp.broadcast_to(v[None], (B,) + v.shape)
              for k, v in prob.ocp.params.items()}
    U0 = jnp.tile(prob.static_input[None], (ns, 1))
    st = jax.vmap(lambda x: off.init(x, U0=U0))(x0)
    st = jax.jit(off.solve_batch)(st, x0, params)
    period = 2 * wpg.step_nodes
    outers, vx, walk_from = (2, 0.15, 10) if quad else (1, 0.1, 0)

    def tick(st, params, ws, action, rdot_ref, pr):
        phase = ws.step_counter % period
        p1, w1 = jax.vmap(wpg.advance)(params, ws, action)
        p1["rdot_ref"] = p1["rdot_ref"].at[:, 1:].set(rdot_ref[:, None, :])
        st, pr = on.serving_tick_batch(st, st.sol.X[:, 1], p1, outers=outers,
                                       prior=pr, phase=phase, prior_ema=1.0)
        return st, p1, w1, pr

    tick = jax.jit(tick)
    ws = jax.vmap(lambda _: wpg.init_state())(jnp.arange(B))
    pr = jax.vmap(lambda _: on.init_full_phase_prior(period, dtype))(
        jnp.arange(B))
    go = jnp.tile(jnp.array([[vx, 0.0, 0.0]], dtype), (B, 1))
    viols = []
    t0 = time.time()
    for k in range(TICKS):
        walking = k >= walk_from
        st, params, ws, pr = tick(
            st, params, ws, jnp.full((B,), int(walking), jnp.int32),
            go if walking else jnp.zeros_like(go), pr)
        viols.append(float(st.viol.max()))
    print(dict(robot=robot, dtype=dt, B=B, **modes,
               window_viol_max=max(viols[61:]),
               viol_max_by_10_ticks=[max(viols[i:i + 10])
                                     for i in range(0, TICKS, 10)],
               seconds=time.time() - t0))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5]))
