"""PyTorch port, the constrained quadruped trot against the JAX package, in
float64 on the CPU, at the full horizon (ns=20).

  - The single robot: the constrained example's offline `ALDDP.solve`
    (`al_serving_options(max_iters=15)`, from the static input tiled), then
    3 ticks of the WPG advance, rdot_ref[1:] = (0.15, 0, 0) and
    solve_online(solve_online(shift_warmstart)) at max_iters=1, with x0 the
    plan's node 1 (examples/quadruped_example.py:47-109).
  - The fleet: `serving_tick_batch(outers=2)` at B=4 with a
    `FullPhasePrior` at EMA 1 and the trot WPG, from each package's own
    batched offline seed (x0 = nominal + 0.01·N(0,1)), 3 ticks.

In both, iterations and convergence flags are equal, and X, U, λ, μ, ρ and
the violation agree to 1e-9 relative (norm-wise, `max_rel_err`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_horizon_tpu_torch.runtime.serving import constrained_tick

from _torch_parity import (
    QUAD_VX, al_state_numpy, fleet_params, jit, max_rel_err, np_of,
    perturbed_states, quadruped_al_solvers, quadruped_isrbd_problems,
    quadruped_trot_wpgs, to_jax, to_torch, torch_constrained_trot,
)

torch.set_num_threads(1)

TICKS = 3
B = 4
TOL = 1e-9
FIELDS = ("lam_eq", "lam_eq_T", "mu_ub", "mu_lb", "mu_x_ub", "mu_x_lb",
          "mu_u_ub", "mu_u_lb", "rho", "viol")


@pytest.fixture(scope="module")
def problems():
    jp, tp = quadruped_isrbd_problems()
    return dict(jp=jp, tp=tp, off=quadruped_al_solvers(jp, tp, 15),
                on=quadruped_al_solvers(jp, tp, 1),
                wpgs=quadruped_trot_wpgs(jp.ocp.ns))


def _agree(got, want, where):
    """Iterations and flags equal; plans and multipliers to TOL."""
    g, w = al_state_numpy(got), al_state_numpy(want)
    for k in ("iterations", "converged"):
        np.testing.assert_array_equal(g["sol"][k], w["sol"][k], err_msg=f"{where}: {k}")
    errs = {k: max_rel_err(g[k], w[k]) for k in FIELDS}
    errs.update({k: max_rel_err(g["sol"][k], w["sol"][k]) for k in ("X", "U", "cost")})
    assert max(errs.values()) < TOL, (where, errs)
    return errs


def _jax_single(problems):
    jp = problems["jp"]
    joff, jon = problems["off"][0], problems["on"][0]
    jwpg = problems["wpgs"][0]
    ns = jp.ocp.ns
    x0 = jp.initial_state
    U0 = jnp.tile(jp.static_input[None], (ns, 1))
    st = jit(joff.solve)(joff.init(x0, U0=U0), x0, jp.ocp.params)
    states = [st]
    tick = jit(lambda st, x0, p: jon.solve_online(
        jon.solve_online(jon.shift_warmstart(st), x0, p), x0, p))
    params, ws = dict(jp.ocp.params), jwpg.init_state()
    for _ in range(TICKS):
        params, ws = jwpg.advance(params, ws, jnp.asarray(1, jnp.int32))
        params["rdot_ref"] = params["rdot_ref"].at[1:].set(
            jnp.array([QUAD_VX, 0.0, 0.0], jnp.float64))
        st = tick(st, st.sol.X[1], params)
        states.append(st)
    return states


def test_single_robot_trot_matches_jax(problems):
    want = _jax_single(problems)
    got = torch_constrained_trot(problems["tp"], problems["off"][1],
                                 problems["on"][1], problems["wpgs"][1], TICKS)
    assert len(got) == len(want) == TICKS + 1
    for t, (g, w) in enumerate(zip(got, want)):
        _agree(g, w, "offline solve" if t == 0 else f"tick {t}")
    # the offline solve converges as the example's does
    assert float(got[0].viol) < 1e-3
    assert int(got[0].sol.iterations) == int(want[0].sol.iterations)


def test_fleet_serving_ticks_match_jax(problems):
    jp, tp = problems["jp"], problems["tp"]
    (joff, toff), (jon, ton) = problems["off"], problems["on"]
    jwpg, twpg = problems["wpgs"]
    ns = jp.ocp.ns
    period = 2 * jwpg.step_nodes
    assert period == 2 * twpg.step_nodes
    x0 = perturbed_states(jp.initial_state, B, seed=11)
    params = fleet_params(jp.ocp.params, B)
    U0 = jnp.tile(jp.static_input[None], (ns, 1))
    jst = jax.vmap(lambda x: joff.init(x, U0=U0))(jnp.asarray(x0))
    jst = jit(joff.solve_batch)(jst, jnp.asarray(x0), to_jax(params))
    tx0 = to_torch(x0)
    tU0 = tp.static_input[None].expand(ns, -1)
    tst = toff.solve_batch(toff.init(tx0, tU0), tx0, to_torch(params))
    _agree(tst, jst, "offline seed")

    def jtick(st, params, wst, action, rdot_ref, pr):
        phase = wst.step_counter % period
        p1, w1 = jax.vmap(jwpg.advance)(params, wst, action)
        p1["rdot_ref"] = p1["rdot_ref"].at[:, 1:].set(rdot_ref[:, None, :])
        st, pr = jon.serving_tick_batch(st, st.sol.X[:, 1], p1, outers=2,
                                        prior=pr, phase=phase, prior_ema=1.0)
        return st, p1, w1, pr

    jtick = jit(jtick)
    action = np.ones(B, np.int32)
    rdot = np.tile([[QUAD_VX, 0.0, 0.0]], (B, 1))
    jparams, tparams = to_jax(params), to_torch(params)
    jw = jax.vmap(lambda _: jwpg.init_state())(jnp.arange(B))
    tw = twpg.init_state((B,))
    jpr = jax.vmap(lambda _: jon.init_full_phase_prior(period, jnp.float64))(
        jnp.arange(B))
    tpr = ton.init_full_phase_prior(period, B)
    for t in range(TICKS):
        jst, jparams, jw, jpr = jtick(jst, jparams, jw, jnp.asarray(action),
                                      jnp.asarray(rdot), jpr)
        tst, tparams, tw, tpr = constrained_tick(
            ton, twpg, tst, tparams, tw, torch.as_tensor(action),
            to_torch(rdot), prior=tpr, outers=2, prior_ema=1.0)
        _agree(tst, jst, f"tick {t}")
        for k in ("c_ref", "rdot_ref", "mask_srbd", "mask_lip"):
            np.testing.assert_array_equal(np_of(tparams[k]), np.asarray(jparams[k]))
    for k in jpr._fields:
        g, w = np_of(getattr(tpr, k)), np.asarray(getattr(jpr, k))
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            assert max_rel_err(g, w) < TOL, k
    assert bool(tpr.seen[:, :TICKS].all()) and not bool(tpr.seen[:, TICKS:].any())
