"""PyTorch port, the walking-pattern generator's `terrain_z`, against the
JAX package's `WalkingPatternGenerator.advance(..., terrain_z=)`
(srbd_horizon_tpu/wpg.py:159-237) on the CPU in float64:

  - a 30-tick schedule mixing stance, step and jump, three members
    advanced in one batched call on the port's side and one by one on
    JAX's, with one terrain height for the fleet (a Python scalar) and with
    one a member (a (B,) tensor): c_ref, cdot_switch, w_ref and
    orientation_tracking_gain equal entry for entry, on the step action's
    terminal c_ref (the cycle + terrain), in stance (the terrain height in
    place of 0) and under the jump action (the shifted c_ref kept);
  - a short closed loop after tests/test_robustness.py's
    `test_steps_onto_raised_terrain`: a walk on flat ground, then steps
    onto 4 cm terrain through `advance(..., terrain_z=0.04)`; the stance
    references of the whole horizon move to 4 cm and the realized contact
    heights follow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_horizon_tpu import wpg as jwpg
from srbd_horizon_tpu_torch import wpg as twpg
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.runtime.loop import build_srbd_loop, walking_schedule

from _torch_parity import fleet_params, jit, np_of, problems

torch.set_num_threads(1)

T = 30
FIELDS = ("c_ref", "cdot_switch", "w_ref", "orientation_tracking_gain")
TERRAIN = [0.04, -0.02, 0.1]


def _schedules():
    """Three members: a stance/step/jump mix, a walker that jumps
    mid-gait, and a pseudo-random schedule."""
    rng = np.random.RandomState(9)
    a = [0] * 5 + [1] * 12 + [2] * 3 + [1] * 6 + [0] * 4
    b = [1] * 9 + [2] * 2 + [1] * 13 + [0] * 6
    c = list(rng.randint(0, 3, size=T))
    return np.array([a, b, c], np.int32)            # (members, T)


@pytest.mark.parametrize("per_member", [False, True],
                         ids=["scalar", "batched"])
def test_advance_with_terrain_matches_jax(per_member):
    jp, _ = problems()
    ns = jp.ocp.ns
    sched = _schedules()
    M = sched.shape[0]
    jg = jwpg.WalkingPatternGenerator.build(0.0, ns, dtype=jnp.float64)
    tg = twpg.WalkingPatternGenerator.build(0.0, ns, dtype=torch.float64,
                                            device="cpu")
    tz = TERRAIN if per_member else [TERRAIN[0]] * M
    base = fleet_params(jp.ocp.params, M)
    jparams = [{k: jnp.asarray(v[m]) for k, v in base.items()} for m in range(M)]
    jstates = [jg.init_state() for _ in range(M)]
    jadvance = jit(jg.advance)
    tparams = {k: torch.as_tensor(v) for k, v in base.items()}
    tstate = tg.init_state((M,))
    t_tz = torch.tensor(TERRAIN, dtype=torch.float64) if per_member else TERRAIN[0]
    seen = set()
    for t in range(T):
        for m in range(M):
            jparams[m], jstates[m] = jadvance(jparams[m], jstates[m],
                                              int(sched[m, t]), tz[m])
        tparams, tstate = tg.advance(tparams, tstate,
                                     torch.as_tensor(sched[:, t]),
                                     terrain_z=t_tz)
        seen.update(int(a) for a in sched[:, t])
        for k in FIELDS:
            want = np.stack([np.asarray(jparams[m][k]) for m in range(M)])
            np.testing.assert_array_equal(np_of(tparams[k]), want,
                                          err_msg=f"{k} at tick {t}")
    assert seen == {twpg.STANCE, twpg.STEP, twpg.JUMP}
    # the terrain reached the written references: stance nodes at each
    # member's height
    c_ref = np_of(tparams["c_ref"])
    for m in range(M):
        assert np.isclose(c_ref[m], tz[m]).any()


@pytest.mark.parametrize("terrain", ["default", "scalar", "float64_tensor"])
def test_terrain_keeps_the_wpg_dtype(terrain):
    """A float32 WPG stays float32 under any `terrain_z`: a Python scalar
    (the default 0.0 included) is added on the host, a tensor is cast to
    the references' dtype; the default writes what terrain 0 writes."""
    ns = 8
    tg = twpg.WalkingPatternGenerator.build(0.0, ns, dtype=torch.float32,
                                            device="cpu")
    params = {"c_ref": torch.zeros(3, ns + 1, 4),
              "cdot_switch": torch.ones(3, ns + 1, 4),
              "w_ref": torch.zeros(3, ns + 1, 3),
              "orientation_tracking_gain": torch.full((3, ns + 1, 1), 10.0)}
    kw = {"default": {}, "scalar": {"terrain_z": 0.0},
          "float64_tensor": {"terrain_z": torch.zeros(3, dtype=torch.float64)}}
    action = torch.tensor([0, 1, 2], dtype=torch.int32)
    got, _ = tg.advance(params, tg.init_state((3,)), action, **kw[terrain])
    flat, _ = tg.advance(params, tg.init_state((3,)), action, terrain_z=0)
    for k in FIELDS:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], flat[k]), k


def test_steps_onto_raised_terrain():
    """The port's closed loop (Kangaroo, float64, CPU): a walk on flat
    ground, then `advance(..., terrain_z=0.04)` with the step action each
    tick, the solve and the Euler self-simulation, as the JAX package's
    test drives it; the horizon's stance references reach 4 cm, the swing
    apex sits above them, and the realized contact heights follow (the
    1e6 cz-tracking weight)."""
    F64 = torch.float64
    ns = 10
    loop, prob = build_srbd_loop(
        SRBDConfig(dtype=F64, ns=ns, T=0.05 * ns),
        DDPOptions(max_iters=20, alpha_converge_threshold=1e-12, beta=1e-3),
        shift_warmstart=False, device="cpu")
    carry = loop.init(prob.initial_state)
    carry, _ = loop.run(carry, walking_schedule(10, vx=0.2, start=5,
                                                dtype=F64, device="cpu"))
    ocp = loop.ocp
    step = torch.tensor(twpg.STEP, dtype=torch.int32)
    for _ in range(ns + 5):
        params, wst = loop.wpg.advance(carry.params, carry.wpg_state, step,
                                       terrain_z=0.04)
        sol = loop.solver.solve(carry.sol, carry.x, params)
        x_next = ocp.step(carry.x, sol.U[0], ocp.params_at(params, 0), ocp.dt)
        carry = carry._replace(x=x_next, sol=sol, params=params,
                               wpg_state=wst)
    c_ref = np_of(carry.params["c_ref"])
    assert c_ref.max() > 0.04
    stance = c_ref[np_of(carry.params["cdot_switch"]) > 0.5]
    np.testing.assert_allclose(stance.min(), 0.04, atol=1e-9)
    x = np_of(carry.x)
    assert np.all(np.isfinite(x))
    cz = x[[7 + 2, 10 + 2, 13 + 2, 16 + 2]]
    assert cz.max() > 0.03, cz
