"""PyTorch port, the dlip example's 40-tick walk against the JAX package,
float64 on the CPU: `build_lip_loop`'s dlip configuration (`max_iters=100`,
`alpha_converge_threshold=1e-12`, `beta=1e-3`, the WPG at the feet's
height, no shift) under `walking_schedule(40, vx=0.3, start=10)`, the
example's schedule, against JAX `MPCLoop.run`.

  - From the nominal state, as the example starts: iterations and
    convergence equal tick by tick; x and the cost within 1e-9 relative
    (read: ≤ 1.6e-13); u0 and the final plans within the merit's rounding
    floor, U_FLOOR = 1e-6 (`tests/test_torch_lip_loop.py`; read ≤ 2.5e-14).
  - From the 12-tick walk's pushed start (0.01·N(0, 1), seed 41), 40
    ticks: iterations equal, the cost within 1e-9, u0 and the plans within
    U_FLOOR (read: u0 5.3e-7 at the largest floor step). Here x departs
    from JAX's by more than u0's floor steps alone move one tick (read:
    1.4e-9 relative after 40 ticks): the closed loop integrates them. The
    test shows that mechanism: JAX's own Euler step driven by the port's
    u0 sequence from the same x0 reproduces the port's states to 1e-12,
    so every difference in x is the integral of the u0 floor steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jit, max_rel_err, np_of
from srbd_horizon_tpu.runtime.loop import walking_schedule as j_walking
from srbd_horizon_tpu_torch import SRBDConfig, build_lip_loop
from srbd_horizon_tpu_torch.runtime.loop import walking_schedule
from test_torch_lip_loop import U_FLOOR, _jax_loop

torch.set_num_threads(1)

F64 = torch.float64
T = 40
START = 10
VX = 0.3
TOL = 1e-9


def _walk(push):
    jp, jloop = _jax_loop()
    tloop, _ = build_lip_loop(SRBDConfig(dtype=F64), device="cpu")
    rng = np.random.RandomState(41)
    x0 = np.array(jp.initial_state) + push * rng.randn(30)
    jc, jo = jit(jloop.run)(jloop.init(jnp.asarray(x0)),
                            j_walking(T, vx=VX, start=START,
                                      dtype=jnp.float64))
    tc, to = tloop.run(tloop.init(torch.as_tensor(x0)),
                       walking_schedule(T, vx=VX, start=START, dtype=F64,
                                        device="cpu"))
    return dict(jp=jp, x0=x0, jc=jc, jo=jo, tc=tc, to=to)


@pytest.fixture(scope="module")
def walks():
    return {"nominal": _walk(0.0), "pushed": _walk(0.01)}


@pytest.fixture(params=["nominal", "pushed"])
def walk(walks, request):
    return walks[request.param]


def test_iterations_equal(walk):
    jo, to = walk["jo"], walk["to"]
    np.testing.assert_array_equal(np_of(to.iterations), np.asarray(jo.iterations))
    np.testing.assert_array_equal(np_of(to.converged), np.asarray(jo.converged))
    assert int(np_of(to.iterations)[-1]) >= 2          # walking


def test_cost_within_1e9(walk):
    assert max_rel_err(walk["to"].cost, walk["jo"].cost) < TOL


def test_u0_and_plans_within_the_floor(walk):
    jo, to, jc, tc = walk["jo"], walk["to"], walk["jc"], walk["tc"]
    assert max_rel_err(to.u0, jo.u0) < U_FLOOR
    for f in ("X", "U"):
        assert max_rel_err(getattr(tc.sol, f), getattr(jc.sol, f)) < U_FLOOR, f


def test_x_within_1e9_on_the_example_walk(walks):
    """The example's walk starts at the nominal state: x within 1e-9."""
    w = walks["nominal"]
    assert max_rel_err(w["to"].x, w["jo"].x) < TOL


def test_x_is_the_integral_of_u0(walk):
    """JAX's Euler step, driven from x0 by the port's u0 sequence,
    reproduces the port's closed-loop states: x differs from JAX's only
    through u0."""
    ocp = walk["jp"].ocp
    step = jit(lambda x, u: ocp.step(x, u, None, ocp.dt))
    x = jnp.asarray(walk["x0"])
    replay = []
    for u in np_of(walk["to"].u0):
        x = step(x, jnp.asarray(u))
        replay.append(np.asarray(x))
    assert max_rel_err(walk["to"].x, np.stack(replay)) < 1e-12
