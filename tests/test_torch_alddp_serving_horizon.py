"""PyTorch port, the constrained path against the JAX package at the serving
horizon (ns=20), in float64 on the CPU.

`test_torch_alddp.py` holds the serving tick at ns=8. This file runs the
same comparison at the horizon the constrained path serves at, where the
inner stage stack has its 240 rows over 20 nodes, the sizes K5, K6 and
isrbd_evaluate are compiled for: from one JAX-side batched offline seed
carried across as numpy, 3 WPG-advanced `serving_tick_batch` ticks with a
`FullPhasePrior` (1 outer × 1 inner iteration, cz stiffness 3200) in both
packages — iterations and convergence flags equal, X, U, λ, viol and cost
to 1e-7 relative, the prior to 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG
from srbd_horizon_tpu_torch.kernels import isrbd_linearize as k5
from srbd_horizon_tpu_torch.runtime.serving import constrained_tick
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator as TWPG

from _torch_parity import (
    F64, al_solvers, al_state_numpy, fleet_params, isrbd_problems, jit,
    max_rel_err, np_of, perturbed_states, to_jax, to_torch, torch_al_state,
)

torch.set_num_threads(1)

B = 2
NS = 20         # the serving horizon
TICKS = 3


@pytest.fixture(scope="module")
def case():
    jp, tp = isrbd_problems(ns=NS, cz_rho_weight=3200.0)
    js, ts = al_solvers(jp, tp, max_iters=3)
    x0 = perturbed_states(jp.initial_state, B, seed=35)
    U0 = jnp.tile(jp.static_input[None], (NS, 1))
    params = fleet_params(jp.ocp.params, B)
    st0 = jax.vmap(lambda x: js.init(x, U0=U0))(jnp.asarray(x0))
    jst = jit(js.solve_batch)(st0, jnp.asarray(x0), to_jax(params))
    return dict(jp=jp, tp=tp, ts=ts, params=params, jst=jst,
                seed=al_state_numpy(jst))


def test_serving_horizon_has_the_kernels_sizes(case):
    ts = case["ts"]
    ocp = case["tp"].ocp
    assert ocp.ns == NS
    assert (k5.kernel_sizes(ts.terms, ocp.nx, ocp.nu, ts.inner.rows)
            == k5.KERNEL_SHAPES["kangaroo"])


def test_serving_ticks_match_jax_at_the_serving_horizon(case):
    jp, tp = case["jp"], case["tp"]
    jon, ton = al_solvers(jp, tp, max_iters=1)
    jwpg = JWPG.build(0.0, NS, dtype=jnp.float64)
    twpg = TWPG.build(0.0, NS, dtype=F64, device="cpu")
    period = 2 * jwpg.step_nodes
    assert period == 2 * twpg.step_nodes

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
    jst, jparams = case["jst"], to_jax(case["params"])
    jw = jax.vmap(lambda _: jwpg.init_state())(jnp.arange(B))
    jpr = jax.vmap(lambda _: jon.init_full_phase_prior(period, jnp.float64))(
        jnp.arange(B))
    tst, tparams = torch_al_state(case["seed"]), to_torch(case["params"])
    tw = twpg.init_state((B,))
    tpr = ton.init_full_phase_prior(period, B)
    worst = {}
    for t in range(TICKS):
        jst, jparams, jw, jpr = jtick(jst, jparams, jw, jnp.asarray(action),
                                      jnp.asarray(rdot), jpr)
        tst, tparams, tw, tpr = constrained_tick(
            ton, twpg, tst, tparams, tw, torch.as_tensor(action),
            to_torch(rdot), prior=tpr, outers=1, prior_ema=1.0)
        g, w = al_state_numpy(tst), al_state_numpy(jst)
        for k in ("iterations", "converged"):
            np.testing.assert_array_equal(g["sol"][k], w["sol"][k],
                                          err_msg=f"tick {t}: {k}")
        errs = {k: max_rel_err(g[k], w[k]) for k in ("lam_eq", "lam_eq_T", "viol", "rho")}
        errs.update({k: max_rel_err(g["sol"][k], w["sol"][k]) for k in ("X", "U", "cost")})
        assert max(errs.values()) < 1e-7, (t, errs)
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in errs.items()}
        for k in ("c_ref", "rdot_ref"):
            np.testing.assert_array_equal(np_of(tparams[k]), np.asarray(jparams[k]))
    assert int(tst.sol.iterations.max()) == 1
    for k in jpr._fields:
        np.testing.assert_allclose(np_of(getattr(tpr, k)), np.asarray(getattr(jpr, k)),
                                   rtol=1e-7, atol=1e-7)
    assert bool(tpr.seen[:, :TICKS].all()) and not bool(tpr.seen[:, TICKS:].any())
    print("worst relative errors over the ticks:", worst)
