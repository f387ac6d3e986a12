"""PyTorch port, the quadruped's batched path in float64 on the CPU:
`MSDDP.solve_batch` at B=6 from states pushed by 0.02·N(0, 1)
(`max_iters=6`, as the JAX package's `tests/test_quadruped.py` runs it)
against the JAX package's `solve_batch`, and the fleet tick
(`MPCLoop.tick_batch`: the quadruped example's options with the shifted
warm start, a walk command at vx 0.25 and 0.1, the trot WPG) at B=3 over
3 ticks against JAX's `tick_batch`. Iterations and convergence equal;
plans, costs and states within 1e-9 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    fleet_params,
    jit,
    max_rel_err,
    np_of,
    quadruped_loops,
    quadruped_problems,
    solvers,
    to_jax,
    to_torch,
)
from srbd_horizon_tpu.runtime.loop import TickInput as JTickInput
from srbd_horizon_tpu_torch.runtime.loop import TickInput as TTickInput

torch.set_num_threads(1)

TOL = 1e-9
F64 = torch.float64


@pytest.fixture(scope="module")
def batch():
    jp, tp = quadruped_problems()
    js, ts = solvers(jp, tp, max_iters=6)
    B = 6
    rng = np.random.RandomState(2)
    x0 = np.asarray(jp.initial_state)[None] + 0.02 * rng.randn(B, 37)
    params = fleet_params(jp.ocp.params, B)
    jsol = jax.vmap(js.init)(jnp.asarray(x0))
    want = jit(js.solve_batch)(jsol, jnp.asarray(x0), to_jax(params))
    got = ts.solve_batch(ts.init(to_torch(x0)), to_torch(x0), to_torch(params))
    return got, want


def test_solve_batch_iterations_equal(batch):
    got, want = batch
    np.testing.assert_array_equal(np_of(got.iterations), np.asarray(want.iterations))
    np.testing.assert_array_equal(np_of(got.converged), np.asarray(want.converged))
    assert int(np_of(got.iterations).min()) > 1


@pytest.mark.parametrize("field", ["X", "U", "cost"])
def test_solve_batch_matches_jax(batch, field):
    got, want = batch
    assert tuple(getattr(got, field).shape) == getattr(want, field).shape
    assert max_rel_err(getattr(got, field), getattr(want, field)) < TOL


def test_solve_batch_defect_norm_matches_jax(batch):
    got, want = batch
    np.testing.assert_allclose(np_of(got.defect_norm), np.asarray(want.defect_norm),
                               rtol=0, atol=1e-12)


def test_fleet_tick_matches_jax():
    jp, jloop, tloop, _ = quadruped_loops(shift=True)
    B = 3
    rng = np.random.RandomState(5)
    x0 = np.asarray(jp.initial_state)[None] + 0.01 * rng.randn(B, 37)
    rdot = np.array([[0.25, 0.0, 0.0], [0.1, 0.0, 0.0], [0.25, 0.0, 0.0]])
    jinp = JTickInput(action=jnp.ones(B, jnp.int32), rdot_ref=jnp.asarray(rdot),
                      w_ref=jnp.zeros((B, 3)))
    tinp = TTickInput(action=torch.ones(B, dtype=torch.int32),
                      rdot_ref=torch.as_tensor(rdot),
                      w_ref=torch.zeros((B, 3), dtype=F64))
    jtick = jit(jloop.tick_batch)
    jc = jax.vmap(jloop.init)(jnp.asarray(x0))
    tc = tloop.init(torch.as_tensor(x0))
    for _ in range(3):
        jc, jo = jtick(jc, jinp)
        tc, to = tloop.tick_batch(tc, tinp)
        np.testing.assert_array_equal(np_of(to.iterations), np.asarray(jo.iterations))
        for f in ("x", "u0", "cost"):
            assert max_rel_err(getattr(to, f), getattr(jo, f)) < TOL, f
        np.testing.assert_allclose(np_of(to.srbd_residual),
                                   np.asarray(jo.srbd_residual), atol=1e-12)
    assert max_rel_err(tc.sol.X, jc.sol.X) < TOL
    np.testing.assert_array_equal(np_of(tc.params["cdot_switch"]),
                                  np.asarray(jc.params["cdot_switch"]))
