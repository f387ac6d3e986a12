"""PyTorch port, the point-feet quadruped's SRBD problem under the JAX
package's other execution modes (K12 at `QuadShape` with either gain
solve, K13's quadruped SRBD family), in float64 on the CPU (the kernels'
plain twins), against the JAX package with the same options:

- `MSDDP.solve` from a pushed nominal start with a commanded terminal
  velocity, under each of the three non-default combinations and with the
  Cholesky gains under associative/linear: iterations and convergence
  equal, X, U and cost to 1e-9, the final defect to 1e-12; one K12 sweep
  an iteration under the associative sweep (K1 none), K13 on the linear
  trials only;
- the quadruped example's loop (`build_quadruped_loop`) under
  associative/linear: `MPCLoop.run` over 8 ticks of
  `walking_schedule(vx=0.25, start=2)` against JAX's `run`, and
  `tick_batch` with the warm start shifted at B=4 for 3 ticks against
  JAX's: iterations and convergence equal, x, u0, cost and the plans to
  1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    MODES, MODE_IDS, ModesSpy, jit, max_rel_err, modes, np_of,
    perturbed_states, quadruped_loops, quadruped_problems, to_jax, to_torch,
)
from srbd_horizon_tpu.config import DDPOptions as JDDPOptions
from srbd_horizon_tpu.runtime.loop import TickInput as JTickInput
from srbd_horizon_tpu.runtime.loop import walking_schedule as j_walking
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP
from srbd_horizon_tpu_torch.config import DDPOptions
from srbd_horizon_tpu_torch.convert import tick_input_from_numpy
from srbd_horizon_tpu_torch.runtime.loop import walking_schedule
from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

torch.set_num_threads(1)

SOLVE_OPTS = dict(max_iters=20, alpha_converge_threshold=1e-12, beta=1e-3)
CASES = [m + ("schur",) for m in MODES] + [("associative", "linear",
                                            "cholesky")]
CASE_IDS = MODE_IDS + ["associative-linear-cholesky"]
FLEET_MODE = modes("associative", "linear")
B = 4


@pytest.fixture(scope="module")
def solves():
    jp, tp = quadruped_problems()
    params = {k: np.asarray(v) for k, v in jp.ocp.params.items()}
    params["rdot_ref"] = params["rdot_ref"].copy()
    params["rdot_ref"][-1] = [0.25, 0.0, 0.0]
    x0 = perturbed_states(jp.initial_state, 1, seed=17, scale=0.01)[0]
    out = {}
    for case in CASES:
        opts = dict(SOLVE_OPTS, quu_solver=case[2], **modes(*case[:2]))
        js, ts = JMSDDP(jp.ocp, JDDPOptions(**opts)), MSDDP(tp.ocp,
                                                           DDPOptions(**opts))
        jsol = jit(js.solve)(js.init(to_jax(x0)), to_jax(x0),
                             to_jax(params))
        spy = ModesSpy(ts)
        tsol = ts.solve(ts.init(to_torch(x0)), to_torch(x0), to_torch(params))
        out[case] = (jsol, tsol, spy)
    return out


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_quadruped_solve_matches_jax(solves, case):
    jsol, tsol, spy = solves[case]
    assert int(tsol.iterations) == int(jsol.iterations) > 2
    assert bool(tsol.converged) == bool(jsol.converged)
    for f in ("X", "U", "cost"):
        assert max_rel_err(getattr(tsol, f), getattr(jsol, f)) < 1e-9, f
    assert abs(float(tsol.defect_norm) - float(jsol.defect_norm)) < 1e-12
    spy.check(case[:2])


def test_quadruped_run_matches_jax_under_the_modes():
    """The quadruped example's loop under associative/linear, 8 ticks."""
    T, start, vx = 8, 2, 0.25
    jp, jloop, tloop, tp = quadruped_loops(**FLEET_MODE)
    spy = ModesSpy(tloop.solver)
    x0 = np.array(jp.initial_state)
    jc, jo = jit(jloop.run)(jloop.init(jnp.asarray(x0)),
                            j_walking(T, vx=vx, start=start,
                                      dtype=jnp.float64))
    tc, to = tloop.run(tloop.init(torch.as_tensor(x0)),
                       walking_schedule(T, vx=vx, start=start,
                                        dtype=torch.float64, device="cpu"))
    np.testing.assert_array_equal(np_of(to.iterations), np.asarray(jo.iterations))
    np.testing.assert_array_equal(np_of(to.converged), np.asarray(jo.converged))
    for f in ("x", "u0", "cost"):
        assert max_rel_err(getattr(to, f), getattr(jo, f)) < 1e-9, f
    for f in ("X", "U"):
        assert max_rel_err(getattr(tc.sol, f), getattr(jc.sol, f)) < 1e-9, f
    np.testing.assert_allclose(np_of(to.defect_norm), np.asarray(jo.defect_norm),
                               rtol=0, atol=1e-12)
    spy.check(("associative", "linear"))
    assert spy.iterations == int(np_of(to.iterations).sum())


def test_quadruped_tick_batch_matches_jax_under_the_modes():
    """`tick_batch` at B=4 with the warm start shifted, 3 ticks of mixed
    actions, under associative/linear (the batched solve is JAX's
    `vmap(solve)`)."""
    jp, jloop, tloop, tp = quadruped_loops(shift=True, **FLEET_MODE)
    spy = ModesSpy(tloop.solver)
    x0 = perturbed_states(jp.initial_state, B, seed=7)
    actions = np.array([0, 1, 1, 1], np.int32)
    rdot = np.tile([0.2, 0.0, 0.0], (B, 1))
    jinp = JTickInput(action=jnp.asarray(actions), rdot_ref=jnp.asarray(rdot),
                      w_ref=jnp.zeros((B, 3)))
    tinp = tick_input_from_numpy(actions, rdot, np.zeros((B, 3)), device="cpu",
                                 dtype=torch.float64)
    jtick = jit(jloop.tick_batch)
    jc = jax.vmap(jloop.init)(jnp.asarray(x0))
    tc = tloop.init(torch.as_tensor(x0))
    for _ in range(3):
        jc, jo = jtick(jc, jinp)
        tc, to = tloop.tick_batch(tc, tinp)
        np.testing.assert_array_equal(to.iterations.numpy(),
                                      np.asarray(jo.iterations))
        np.testing.assert_array_equal(to.converged.numpy(),
                                      np.asarray(jo.converged))
        for f in ("x", "u0", "cost"):
            assert max_rel_err(getattr(to, f), getattr(jo, f)) < 1e-9, f
        for f in ("X", "U"):
            assert max_rel_err(getattr(tc.sol, f), getattr(jc.sol, f)) < 1e-9, f
    assert float(to.defect_norm.max()) < 1e-4
    spy.check(("associative", "linear"))
