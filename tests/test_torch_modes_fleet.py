"""PyTorch port, the fleet entry points under the JAX package's other
execution modes (`riccati_mode="associative"`, K12, with
`forward_pass="linear"`, K13) in float64 on the CPU (the kernels' plain
twins): `MSDDP.solve_batch` at B=4 against `jit(js.solve_batch)`,
which is JAX's `vmap(solve)` under these modes (msddp.py:1213-1216), and
`MPCLoop.tick_batch` for 3 ticks at B=4 against JAX's; iterations and
convergence flags equal, plans to 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    jit, max_rel_err, perturbed_states, problems, solvers, to_jax, to_torch,
)
from srbd_horizon_tpu.runtime.loop import MPCLoop as JLoop
from srbd_horizon_tpu.runtime.loop import TickInput as JTickInput
from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG
from srbd_horizon_tpu_torch.convert import tick_input_from_numpy
from srbd_horizon_tpu_torch.runtime.loop import MPCLoop as TLoop
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator as TWPG

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def srbd():
    jp, tp = problems()
    params = {k: np.asarray(v) for k, v in jp.ocp.params.items()}
    params["rdot_ref"] = params["rdot_ref"].copy()
    params["rdot_ref"][-1] = [0.3, 0.0, 0.0]
    return jp, tp, params, None


B = 4
ACTIONS = np.array([0, 1, 1, 2], np.int32)
RDOT = np.tile([0.2, 0.0, 0.0], (B, 1))
FLEET_MODE = dict(riccati_mode="associative", forward_pass="linear")


def test_solve_batch_matches_jax_vmap_solve(srbd):
    """`solve_batch` under associative/linear is JAX's vmap(solve): the
    unbatched chunk grid, the sweep's `quu_solver`, members frozen once
    converged; iterations and flags equal, plans to 1e-9."""
    jp, tp, params, _ = srbd
    js, ts = solvers(jp, tp, max_iters=8, quu_solver="cholesky", **FLEET_MODE)
    x0 = perturbed_states(jp.initial_state, B, seed=8, scale=0.05)
    P = {k: np.broadcast_to(v[None], (B,) + v.shape).copy()
         for k, v in params.items()}
    jsol = jit(js.solve_batch)(jax.vmap(js.init)(to_jax(x0)), to_jax(x0),
                               to_jax(P))
    syncs0 = ts.host_syncs
    tsol = ts.solve_batch(ts.init(to_torch(x0)), to_torch(x0), to_torch(P))
    syncs = ts.host_syncs - syncs0
    np.testing.assert_array_equal(tsol.iterations.numpy(),
                                  np.asarray(jsol.iterations))
    np.testing.assert_array_equal(tsol.converged.numpy(),
                                  np.asarray(jsol.converged))
    assert len(set(tsol.iterations.tolist())) > 1   # members freeze apart
    for f in ("X", "U", "cost"):
        assert max_rel_err(getattr(tsol, f), getattr(jsol, f)) < 1e-9, f
    np.testing.assert_allclose(tsol.defect_norm.numpy(),
                               np.asarray(jsol.defect_norm), atol=1e-12)
    # one read a loop turn, one a fan chunk after the first
    assert int(tsol.iterations.max()) + 1 <= syncs


@pytest.fixture(scope="module")
def fleet_loops():
    jp, tp = problems()
    js, ts = solvers(jp, tp, max_iters=5, **FLEET_MODE)
    jloop = JLoop(solver=js, wpg=JWPG.build(0.0, jp.ocp.ns, dtype=jnp.float64),
                  srbd_constants=jp.ocp.constants, shift_warmstart=True)
    tloop = TLoop(solver=ts, wpg=TWPG.build(0.0, tp.ocp.ns, dtype=torch.float64,
                                            device="cpu"),
                  srbd_constants=tp.ocp.constants, shift_warmstart=True)
    return jp, jloop, tloop


def test_tick_batch_matches_jax(fleet_loops):
    jp, jloop, tloop = fleet_loops
    x0 = perturbed_states(jp.initial_state, B, seed=7)
    jinp = JTickInput(action=jnp.asarray(ACTIONS), rdot_ref=jnp.asarray(RDOT),
                      w_ref=jnp.zeros((B, 3)))
    tinp = tick_input_from_numpy(ACTIONS, RDOT, np.zeros((B, 3)), device="cpu",
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
        assert max_rel_err(to.x, jo.x) < 1e-9
        assert max_rel_err(to.u0, jo.u0) < 1e-9
        assert max_rel_err(tc.sol.X, jc.sol.X) < 1e-9
        assert max_rel_err(tc.sol.U, jc.sol.U) < 1e-9
    assert float(to.defect_norm.max()) < 1e-4
