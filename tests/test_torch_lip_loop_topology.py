"""PyTorch port, the LIP closed loop at the point-feet biped in float64 on
the CPU: `build_lip_loop(SRBDConfig(contact_model=1, number_of_legs=2),
robot=point_feet())` builds its WPG with that topology (two contacts, one
a foot), as `build_srbd_loop` does, and `MPCLoop.run` over 5 ticks of
`walking_schedule(vx=0.3, start=1)` matches the JAX package's `MPCLoop` on
`build_lip_problem(cfg, point_feet())` with
`WalkingPatternGenerator.build(..., contact_model=1, number_of_legs=2)`:
iterations equal tick by tick, the cost within 1e-9, u0 and x within 1e-6
(the LIP's merit floor, tests/test_torch_lip_loop.py: its last iteration's
Armijo decision can flip with the order of sums and move u0 along
directions the cost does not see)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jit, max_rel_err, np_of
from srbd_horizon_tpu.config import DDPOptions as JDDPOptions
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig
from srbd_horizon_tpu.models.kangaroo import point_feet as j_point_feet
from srbd_horizon_tpu.problems.lip import build_lip_problem as j_build
from srbd_horizon_tpu.runtime.loop import MPCLoop as JLoop
from srbd_horizon_tpu.runtime.loop import walking_schedule as j_walking
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP
from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG
from srbd_horizon_tpu_torch import build_lip_loop
from srbd_horizon_tpu_torch.config import SRBDConfig
from srbd_horizon_tpu_torch.models.kangaroo import point_feet
from srbd_horizon_tpu_torch.runtime.loop import walking_schedule

torch.set_num_threads(1)

F64 = torch.float64
T = 5
TOPOLOGY = dict(contact_model=1, number_of_legs=2)
DLIP = dict(max_iters=100, alpha_converge_threshold=1e-12, beta=1e-3)
COST_TOL = 1e-9
U_FLOOR = 1e-6


@pytest.fixture(scope="module")
def walk():
    jp = j_build(JSRBDConfig(dtype=jnp.float64, **TOPOLOGY), j_point_feet())
    jwpg = JWPG.build(c_init_z=float(jp.initial_foot_position[0, 2]),
                      nodes=jp.ocp.ns, dtype=jnp.float64, **TOPOLOGY)
    jloop = JLoop(solver=JMSDDP(jp.ocp, JDDPOptions(**DLIP)), wpg=jwpg)
    tloop, tp = build_lip_loop(SRBDConfig(dtype=F64, **TOPOLOGY),
                               robot=point_feet(), device="cpu")
    x0 = np.asarray(jp.initial_state) + 0.01 * np.random.RandomState(
        43).randn(jp.ocp.nx)
    jc, jo = jit(jloop.run)(jloop.init(jnp.asarray(x0)),
                            j_walking(T, vx=0.3, start=1, dtype=jnp.float64))
    tc, to = tloop.run(tloop.init(torch.as_tensor(x0)),
                       walking_schedule(T, vx=0.3, start=1, dtype=F64,
                                        device="cpu"))
    return dict(tloop=tloop, tp=tp, jo=jo, to=to)


def test_wpg_takes_the_point_feet_topology(walk):
    wpg = walk["tloop"].wpg
    assert (wpg.contact_model, wpg.number_of_legs) == (1, 2)
    assert walk["tp"].ocp.params["c_ref"].shape[-1] == 2


def test_point_feet_lip_loop_matches_jax(walk):
    jo, to = walk["jo"], walk["to"]
    np.testing.assert_array_equal(np_of(to.iterations),
                                  np.asarray(jo.iterations))
    assert max_rel_err(to.cost, jo.cost) < COST_TOL
    for f in ("u0", "x"):
        assert tuple(getattr(to, f).shape) == getattr(jo, f).shape, f
        assert max_rel_err(getattr(to, f), getattr(jo, f)) < U_FLOOR, f
