"""PyTorch port, the AL solver under the JAX package's other execution
modes — `riccati_mode="associative"` (K12 at the isrbd-AL shape, with the
Cholesky gain solve the AL solver always asks for) and
`forward_pass="linear"` (K13's isrbd-AL family, RK2 defects) — in float64
on the CPU (the kernels' plain twins), on the Kangaroo's isrbd problem at
ns=8 against the JAX package with the same options:

- `ALDDP.solve` (2 outers × 3 inner iterations from ρ₀ 1e3), then the
  warm start shifted and two `solve_online`s, under each of the three
  non-default combinations: iterations and convergence equal; X, U, cost,
  multipliers, ρ and the violation to 1e-9; one K12 sweep an inner
  iteration under the associative sweep and K1 none, K13 on the linear
  trials only;
- every combination reaches the solution of the default modes, as in the
  JAX package;
- `constrained_tick` (`serving_tick_batch`, 1 outer × 1 inner iteration,
  a `FullPhasePrior` at EMA 1, the WPG advanced) at B=4 for 3 ticks under
  associative/linear, from a JAX-made offline seed under the same modes:
  the batched inner solves are JAX's `vmap(solve)` with the Cholesky gain
  solve; the same agreement, the prior tables too.

The quadruped's AL problem: tests/test_torch_modes_quadruped_al.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    F64, MODES, MODE_IDS, ModesSpy, al_agree, al_solvers, al_state_numpy,
    fleet_params, isrbd_problems, jit, max_rel_err, modes, perturbed_states,
    run_al_modes, to_jax, to_torch, torch_al_state,
)
from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG
from srbd_horizon_tpu_torch.runtime.serving import constrained_tick
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator as TWPG

torch.set_num_threads(1)

NS = 8
B = 4
TICKS = 3


@pytest.fixture(scope="module")
def kangaroo():
    jp, tp = isrbd_problems(ns=NS)
    out = {mode: run_al_modes(jp, tp, mode) for mode in MODES}
    # the port under the default modes, the modes' own reference
    out["default"] = run_al_modes(jp, tp, ("sequential", "nonlinear"),
                                  jax_side=False)
    return out


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_alddp_solve_and_online_match_jax(kangaroo, mode):
    """The Kangaroo's AL solve and two online solves under `mode`."""
    want, got, spy = kangaroo[mode]
    for name, g, w in zip(("offline solve", "online 1", "online 2"), got, want):
        al_agree(g, w, f"{mode} {name}")
    spy.check(mode)


def test_modes_reach_the_default_modes_solution(kangaroo):
    """The modes agree with each other on the AL path, as they do in the
    JAX package: the port under each mode against the port under the
    defaults, iterations equal, costs to 1e-9, plans and the violation to
    1e-6."""
    ref = kangaroo["default"][1]
    for mode in MODES:
        for g, w in zip(kangaroo[mode][1], ref):
            assert int(g.sol.iterations) == int(w.sol.iterations), mode
            assert max_rel_err(g.sol.cost, w.sol.cost) < 1e-9, mode
            assert max_rel_err(g.sol.X, w.sol.X) < 1e-6, mode
            assert max_rel_err(g.viol, w.viol) < 1e-6, mode


def test_serving_ticks_match_jax_under_the_modes():
    """`constrained_tick` at B=4 under associative/linear for 3 ticks (1
    outer × 1 inner iteration, full prior at EMA 1, shifted warm start) from
    a JAX-made offline seed under the same modes."""
    jp, tp = isrbd_problems(ns=NS, cz_rho_weight=3200.0)
    mode = modes("associative", "linear")
    joff, _ = al_solvers(jp, tp, max_iters=3, ddp=mode)
    jon, ton = al_solvers(jp, tp, max_iters=1, ddp=mode)
    x0 = perturbed_states(jp.initial_state, B, seed=35)
    U0 = jnp.tile(jp.static_input[None], (NS, 1))
    params = fleet_params(jp.ocp.params, B)
    jst = jax.vmap(lambda x: joff.init(x, U0=U0))(jnp.asarray(x0))
    jst = jit(joff.solve_batch)(jst, jnp.asarray(x0), to_jax(params))
    jwpg = JWPG.build(0.0, NS, dtype=jnp.float64)
    twpg = TWPG.build(0.0, NS, dtype=F64, device="cpu")
    period = 2 * jwpg.step_nodes

    def jtick(st, params, wst, action, rdot_ref, pr):
        phase = wst.step_counter % period
        p1, w1 = jax.vmap(jwpg.advance)(params, wst, action)
        p1["rdot_ref"] = p1["rdot_ref"].at[:, 1:].set(rdot_ref[:, None, :])
        st, pr = jon.serving_tick_batch(st, st.sol.X[:, 1], p1, outers=1,
                                        prior=pr, phase=phase, prior_ema=1.0)
        return st, p1, w1, pr

    jtick = jit(jtick)
    action = np.ones(B, np.int32)
    rdot = np.tile([[0.1, 0.0, 0.0]], (B, 1))
    jparams, tparams = to_jax(params), to_torch(params)
    jw = jax.vmap(lambda _: jwpg.init_state())(jnp.arange(B))
    jpr = jax.vmap(lambda _: jon.init_full_phase_prior(period, jnp.float64))(
        jnp.arange(B))
    tst = torch_al_state(al_state_numpy(jst))
    tw = twpg.init_state((B,))
    tpr = ton.init_full_phase_prior(period, B)
    spy = ModesSpy(ton.inner)
    for t in range(TICKS):
        jst, jparams, jw, jpr = jtick(jst, jparams, jw, jnp.asarray(action),
                                      jnp.asarray(rdot), jpr)
        tst, tparams, tw, tpr = constrained_tick(
            ton, twpg, tst, tparams, tw, torch.as_tensor(action),
            to_torch(rdot), prior=tpr, outers=1, prior_ema=1.0)
        al_agree(tst, jst, f"tick {t}")
    # one batched sweep a tick (each member runs its one iteration) through
    # K12's Cholesky gains, K13 on the trials, K1 never
    assert ton.inner.opts.quu_solver == "cholesky"
    spy.check(("associative", "linear"))
    assert spy.k12 == TICKS
    for k in jpr._fields:
        g, w = np.asarray(getattr(tpr, k)), np.asarray(getattr(jpr, k))
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            assert max_rel_err(g, w) < 1e-9, k
    assert bool(tpr.seen[:, :TICKS].all())
