"""PyTorch port, walking-pattern generator: a 30-tick action schedule
mixing stance, step and jump, advanced per member in one batched call on
the torch side and per member on the JAX side — c_ref, cdot_switch,
w_ref and orientation_tracking_gain must match exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srbd_horizon_tpu import wpg as jwpg
from srbd_horizon_tpu_torch import wpg as twpg

from _torch_parity import fleet_params, jit, np_of, problems

torch.set_num_threads(1)

T = 30


def _schedules():
    """Three members: a stance/step/jump mix, a walker that jumps
    mid-gait, and a pseudo-random schedule."""
    rng = np.random.RandomState(5)
    a = [0] * 5 + [1] * 12 + [2] * 3 + [1] * 6 + [0] * 4
    b = [1] * 9 + [2] * 2 + [1] * 13 + [0] * 6
    c = list(rng.randint(0, 3, size=T))
    return np.array([a, b, c], np.int32)            # (members, T)


@pytest.mark.parametrize("profile", ["reference", "smooth"])
def test_build_cycles_match(profile):
    want = jwpg._build_cycles(0.0, 10, 0.8, 0.2, swing_profile=profile)
    got = twpg._build_cycles(0.0, 10, 0.8, 0.2, swing_profile=profile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("profile", ["reference", "smooth"])
def test_advance_schedule_matches_jax(profile):
    jp, _ = problems()
    ns = jp.ocp.ns
    sched = _schedules()
    M = sched.shape[0]
    jg = jwpg.WalkingPatternGenerator.build(0.0, ns, dtype=jnp.float64,
                                            swing_profile=profile)
    tg = twpg.WalkingPatternGenerator.build(0.0, ns, dtype=torch.float64,
                                            swing_profile=profile,
                                            device="cpu")
    base = fleet_params(jp.ocp.params, M)
    jparams = [{k: jnp.asarray(v[m]) for k, v in base.items()} for m in range(M)]
    jstates = [jg.init_state() for _ in range(M)]
    jadvance = jit(jg.advance)
    tparams = {k: torch.as_tensor(v) for k, v in base.items()}
    tstate = tg.init_state((M,))
    for t in range(T):
        for m in range(M):
            jparams[m], jstates[m] = jadvance(jparams[m], jstates[m],
                                              int(sched[m, t]))
        tparams, tstate = tg.advance(tparams, tstate,
                                     torch.as_tensor(sched[:, t]))
        for k in ("c_ref", "cdot_switch", "w_ref", "orientation_tracking_gain"):
            want = np.stack([np.asarray(jparams[m][k]) for m in range(M)])
            np.testing.assert_array_equal(np_of(tparams[k]), want,
                                          err_msg=f"{k} at tick {t}")
        np.testing.assert_array_equal(
            tstate.step_counter.numpy(),
            [int(s.step_counter) for s in jstates])


def test_shift_reference_params_matches_jax():
    rng = np.random.RandomState(6)
    p = {"rdot_ref": rng.randn(21, 3), "oref": rng.randn(21, 4)}
    want = jwpg.shift_reference_params(
        {k: jnp.asarray(v) for k, v in p.items()}, ("rdot_ref", "oref", "x"))
    got = twpg.shift_reference_params(
        {k: torch.as_tensor(v) for k, v in p.items()}, ("rdot_ref", "oref", "x"))
    for k in p:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
