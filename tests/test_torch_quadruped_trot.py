"""PyTorch port, the quadruped example's closed loop: `MPCLoop.run` on the
point-feet quadruped (`build_quadruped_loop`: `max_iters=5`,
`alpha_converge_threshold=1e-12`, `beta=1e-3`, the diagonal-pair trot WPG
at the feet's height, the Newton–Euler telemetry on, no warm-start shift)
over 40 ticks of `walking_schedule(vx=0.25, start=10)` from the nominal
state, as the example starts, against the JAX package's `run`, float64 on
the CPU: iterations and convergence equal tick by tick; x, u0, the cost
and the final plans X, U within 1e-9 relative (read: ≤ 2e-15); the
telemetry and the defect norms within 1e-12 absolute; the contact plan
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jit, max_rel_err, np_of, quadruped_loops
from srbd_horizon_tpu.runtime.loop import walking_schedule as j_walking
from srbd_horizon_tpu_torch.runtime.loop import walking_schedule

torch.set_num_threads(1)

T = 40
START = 10
VX = 0.25           # tests/test_quadruped.py's trot speed
TOL = 1e-9


@pytest.fixture(scope="module")
def trot():
    jp, jloop, tloop, tp = quadruped_loops()
    x0 = np.array(jp.initial_state)
    jc, jo = jit(jloop.run)(jloop.init(jnp.asarray(x0)),
                            j_walking(T, vx=VX, start=START,
                                      dtype=jnp.float64))
    sched = walking_schedule(T, vx=VX, start=START, dtype=torch.float64,
                             device="cpu")
    tc, to = tloop.run(tloop.init(torch.as_tensor(x0)), sched)
    return dict(jc=jc, jo=jo, tc=tc, to=to, sched=sched)


def test_iterations_and_convergence_equal(trot):
    jo, to = trot["jo"], trot["to"]
    np.testing.assert_array_equal(np_of(to.iterations), np.asarray(jo.iterations))
    np.testing.assert_array_equal(np_of(to.converged), np.asarray(jo.converged))
    assert int(np_of(to.iterations).max()) == 5       # the trot runs max_iters
    assert int(trot["sched"].action[-1]) == 1


@pytest.mark.parametrize("field", ["x", "u0", "cost"])
def test_outputs_match_jax(trot, field):
    got, want = getattr(trot["to"], field), getattr(trot["jo"], field)
    assert tuple(got.shape) == want.shape
    assert max_rel_err(got, want) < TOL


def test_telemetry_matches_jax(trot):
    jo, to = trot["jo"], trot["to"]
    np.testing.assert_allclose(np_of(to.srbd_residual),
                               np.asarray(jo.srbd_residual), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np_of(to.defect_norm), np.asarray(jo.defect_norm),
                               rtol=0, atol=1e-12)


def test_final_carry_matches_jax(trot):
    jc, tc = trot["jc"], trot["tc"]
    for f in ("X", "U"):
        assert max_rel_err(getattr(tc.sol, f), getattr(jc.sol, f)) < TOL, f
    for k in ("c_ref", "cdot_switch", "rdot_ref", "orientation_tracking_gain"):
        np.testing.assert_array_equal(np_of(tc.params[k]), np.asarray(jc.params[k]))
    assert int(tc.wpg_state.step_counter) == T
