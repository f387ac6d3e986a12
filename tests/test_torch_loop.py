"""PyTorch port, closed loop: `MPCLoop.tick_batch` against the JAX
package's, in float64 on the CPU — a 5-tick walk with the shifted warm
start, a carry handed over from the JAX side through `convert`, and
`chunk_map`. Tolerances are those of
tests/test_batched_solver.py::TestTickBatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jit, np_of, perturbed_states, problems, solvers
from srbd_horizon_tpu.runtime.loop import MPCLoop as JLoop
from srbd_horizon_tpu.runtime.loop import TickInput as JTickInput
from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG
from srbd_horizon_tpu_torch.config import DDPOptions
from srbd_horizon_tpu_torch.convert import carry_from_numpy, tick_input_from_numpy
from srbd_horizon_tpu_torch.runtime.chunked import chunk_map
from srbd_horizon_tpu_torch.runtime.loop import MPCLoop as TLoop
from srbd_horizon_tpu_torch.runtime.loop import build_srbd_loop
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator as TWPG

torch.set_num_threads(1)

B = 4
ACTIONS = np.array([0, 1, 1, 2], np.int32)
RDOT = np.tile([0.2, 0.0, 0.0], (B, 1))


@pytest.fixture(scope="module")
def loops():
    jp, tp = problems()
    js, ts = solvers(jp, tp)
    jloop = JLoop(solver=js, wpg=JWPG.build(0.0, jp.ocp.ns, dtype=jnp.float64),
                  srbd_constants=jp.ocp.constants, shift_warmstart=True)
    tloop = TLoop(solver=ts, wpg=TWPG.build(0.0, tp.ocp.ns, dtype=torch.float64,
                                            device="cpu"),
                  srbd_constants=tp.ocp.constants, shift_warmstart=True)
    x0 = perturbed_states(jp.initial_state, B, seed=7)
    jinp = JTickInput(action=jnp.asarray(ACTIONS), rdot_ref=jnp.asarray(RDOT),
                      w_ref=jnp.zeros((B, 3)))
    tinp = tick_input_from_numpy(ACTIONS, RDOT, np.zeros((B, 3)),
                                 device="cpu", dtype=torch.float64)
    return dict(jloop=jloop, tloop=tloop, jtick=jit(jloop.tick_batch),
                x0=x0, jinp=jinp, tinp=tinp)


def _compare(jc, jo, tc, to, rtol, atol):
    np.testing.assert_allclose(to.x.numpy(), np.asarray(jo.x), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(to.iterations.numpy(), np.asarray(jo.iterations))
    np.testing.assert_array_equal(to.converged.numpy(), np.asarray(jo.converged))
    np.testing.assert_allclose(tc.params["c_ref"].numpy(),
                               np.asarray(jc.params["c_ref"]), atol=1e-12)
    np.testing.assert_allclose(to.srbd_residual.numpy(),
                               np.asarray(jo.srbd_residual), atol=1e-7)


def test_tick_batch_walk_matches_jax(loops):
    jloop, tloop = loops["jloop"], loops["tloop"]
    jc = jax.vmap(jloop.init)(jnp.asarray(loops["x0"]))
    tc = tloop.init(torch.as_tensor(loops["x0"]))
    for t in range(5):
        jc, jo = loops["jtick"](jc, loops["jinp"])
        tc, to = tloop.tick_batch(tc, loops["tinp"])
        if t == 0:
            _compare(jc, jo, tc, to, rtol=1e-7, atol=1e-8)
        else:
            _compare(jc, jo, tc, to, rtol=1e-6, atol=1e-7)
    assert bool(torch.isfinite(tc.sol.X).all())
    np.testing.assert_array_equal(tc.wpg_state.step_counter.numpy(), [5] * B)


def test_carry_handed_over_from_jax(loops):
    """Two JAX ticks, then the carry crosses to the port (numpy only) and
    both packages take two more ticks from the same state."""
    jloop, tloop = loops["jloop"], loops["tloop"]
    jc = jax.vmap(jloop.init)(jnp.asarray(loops["x0"]))
    for _ in range(2):
        jc, _ = loops["jtick"](jc, loops["jinp"])
    tc = carry_from_numpy(
        np.asarray(jc.x),
        {f: np.asarray(v) for f, v in jc.sol._asdict().items()},
        {k: np.asarray(v) for k, v in jc.params.items()},
        np.asarray(jc.wpg_state.step_counter),
        device="cpu", dtype=torch.float64,
    )
    assert tc.sol.iterations.dtype == torch.int32
    assert tc.sol.converged.dtype == torch.bool
    for _ in range(2):
        jc, jo = loops["jtick"](jc, loops["jinp"])
        tc, to = tloop.tick_batch(tc, loops["tinp"])
        _compare(jc, jo, tc, to, rtol=1e-6, atol=1e-7)


def test_chunk_map_matches_unchunked(loops):
    tloop = loops["tloop"]
    tc = tloop.init(torch.as_tensor(loops["x0"]))
    c1, o1 = tloop.tick_batch(tc, loops["tinp"])
    c2, o2 = chunk_map(tloop.tick_batch, 2)(tc, loops["tinp"])
    np.testing.assert_allclose(o2.x.numpy(), o1.x.numpy(), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(c2.sol.U.numpy(), c1.sol.U.numpy(),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(o2.iterations.numpy(), o1.iterations.numpy())
    with pytest.raises(ValueError):
        chunk_map(tloop.tick_batch, 3)(tc, loops["tinp"])


def test_build_srbd_loop_on_cpu():
    loop, prob = build_srbd_loop(dtype=torch.float64, device="cpu")
    assert loop.shift_warmstart
    assert loop.solver.opts == DDPOptions(max_iters=5)
    assert prob.ocp.nx == 37 and prob.initial_state.device.type == "cpu"
    assert np_of(prob.initial_state).shape == (37,)
