"""PyTorch port, the single-robot closed loop: `MPCLoop.tick` and `run`
against the JAX package's `run` over 15 ticks of `walking_schedule`
(stand 5 ticks, then walk at vx 0.3), in the configuration of its
dsrbd example (`max_iters=100`, `alpha_converge_threshold=1e-12`,
`beta=1e-3`, the WPG at the feet's height, no warm-start shift), float64
on the CPU; `run_batch` against JAX `run_batch` at B=2 with the shifted
warm start; the schedules; and a JAX carry crossing to the port as numpy.
Iterations and convergence are equal tick by tick; the state, the
applied input and the plans agree to 1e-9 relative (read: ≤ 6e-15), the
Newton–Euler telemetry to 1e-9 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    jit, max_rel_err, np_of, perturbed_states, problems, solvers,
)
from srbd_horizon_tpu.runtime.loop import MPCLoop as JLoop
from srbd_horizon_tpu.runtime.loop import TickInput as JTickInput
from srbd_horizon_tpu.runtime.loop import standing_schedule as j_standing
from srbd_horizon_tpu.runtime.loop import walking_schedule as j_walking
from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG
from srbd_horizon_tpu_torch.convert import carry_from_numpy
from srbd_horizon_tpu_torch.runtime.loop import MPCLoop as TLoop
from srbd_horizon_tpu_torch.runtime.loop import TickInput as TTickInput
from srbd_horizon_tpu_torch.runtime.loop import standing_schedule, walking_schedule
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator as TWPG

torch.set_num_threads(1)

T = 15
START = 5
F64 = torch.float64


def _loops(shift, max_iters):
    jp, tp = problems()
    js, ts = solvers(jp, tp, max_iters=max_iters)
    cz = float(np.asarray(jp.initial_foot_position)[0, 2])
    jloop = JLoop(solver=js, wpg=JWPG.build(cz, jp.ocp.ns, dtype=jnp.float64),
                  srbd_constants=jp.ocp.constants, shift_warmstart=shift)
    tloop = TLoop(solver=ts, wpg=TWPG.build(cz, tp.ocp.ns, dtype=F64,
                                            device="cpu"),
                  srbd_constants=tp.ocp.constants, shift_warmstart=shift)
    return jp, jloop, tloop


@pytest.fixture(scope="module")
def single():
    jp, jloop, tloop = _loops(shift=False, max_iters=100)
    x0 = perturbed_states(jp.initial_state, 1, seed=7)[0]
    jc, jo = jit(jloop.run)(jloop.init(jnp.asarray(x0)),
                            j_walking(T, vx=0.3, start=START,
                                      dtype=jnp.float64))
    sched = walking_schedule(T, vx=0.3, start=START, dtype=F64, device="cpu")
    tc, to = tloop.run(tloop.init(torch.as_tensor(x0)), sched)
    return dict(jloop=jloop, tloop=tloop, x0=x0, jc=jc, jo=jo, tc=tc, to=to,
                sched=sched)


def _compare(jo, to, tol=1e-9):
    np.testing.assert_array_equal(np_of(to.iterations), np.asarray(jo.iterations))
    np.testing.assert_array_equal(np_of(to.converged), np.asarray(jo.converged))
    for f in ("x", "u0", "cost"):
        got, want = getattr(to, f), getattr(jo, f)
        assert tuple(got.shape) == want.shape, f
        assert max_rel_err(got, want) < tol, f
    np.testing.assert_allclose(np_of(to.srbd_residual),
                               np.asarray(jo.srbd_residual), atol=1e-9)
    np.testing.assert_allclose(np_of(to.defect_norm), np.asarray(jo.defect_norm),
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_schedules_equal_jax(dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.float64
    for t_s, j_s in ((walking_schedule(T, vx=0.3, vy=-0.1, start=START,
                                       dtype=dtype, device="cpu"),
                      j_walking(T, vx=0.3, vy=-0.1, start=START, dtype=jd)),
                     (standing_schedule(T, dtype=dtype, device="cpu"),
                      j_standing(T, dtype=jd))):
        for a, b in zip(t_s, j_s):
            assert a.dtype == (torch.int32 if b.dtype == jnp.int32 else dtype)
            np.testing.assert_array_equal(np_of(a), np.asarray(b))


def test_run_matches_jax(single):
    jo, to, jc, tc = single["jo"], single["to"], single["jc"], single["tc"]
    assert int(np_of(to.iterations).max()) > 1
    assert int(single["sched"].action[-1]) == 1      # the walk ran
    _compare(jo, to)
    for f in ("X", "U"):
        assert max_rel_err(getattr(tc.sol, f), getattr(jc.sol, f)) < 1e-9, f
    np.testing.assert_array_equal(np_of(tc.params["c_ref"]),
                                  np.asarray(jc.params["c_ref"]))
    assert int(tc.wpg_state.step_counter) == T
    assert tc.x.shape == (37,) and to.x.shape == (T, 37)


def test_ticks_equal_run(single):
    """`run` is `tick` over the schedule, output for output."""
    tloop = single["tloop"]
    carry = tloop.init(torch.as_tensor(single["x0"]))
    for t in range(T):
        carry, out = tloop.tick(carry, TTickInput(*(a[t] for a in single["sched"])))
        for f, v in zip(out._fields, out):
            assert torch.equal(v, getattr(single["to"], f)[t]), (t, f)
    assert torch.equal(carry.sol.X, single["tc"].sol.X)


def test_single_carry_crosses_from_jax(single):
    """The JAX carry after 10 ticks crosses to the port as numpy, and both
    packages take the last 5 ticks from it."""
    jp, jloop, tloop = _loops(shift=False, max_iters=100)
    jsched = j_walking(T, vx=0.3, start=START, dtype=jnp.float64)
    jtick = jit(jloop.tick)
    jc = jloop.init(jnp.asarray(single["x0"]))
    for t in range(10):
        jc, _ = jtick(jc, jax.tree.map(lambda a: a[t], jsched))
    tc = carry_from_numpy(
        np.asarray(jc.x), {f: np.asarray(v) for f, v in jc.sol._asdict().items()},
        {k: np.asarray(v) for k, v in jc.params.items()},
        np.asarray(jc.wpg_state.step_counter), device="cpu", dtype=F64)
    assert tc.sol.iterations.dim() == 0 and tc.sol.iterations.dtype == torch.int32
    assert tc.wpg_state.step_counter.dim() == 0
    for t in range(10, T):
        jc, jo = jtick(jc, jax.tree.map(lambda a: a[t], jsched))
        tc, to = tloop.tick(tc, TTickInput(*(a[t] for a in single["sched"])))
        np.testing.assert_array_equal(np_of(to.iterations), np.asarray(jo.iterations))
        assert max_rel_err(to.x, jo.x) < 1e-9
    assert max_rel_err(tc.sol.U, jc.sol.U) < 1e-9


def test_run_batch_matches_jax():
    """B=2 members walking at vx 0.3 and 0.1, the shifted warm start,
    `max_iters=8`: `run_batch` equals JAX `run_batch` tick by tick."""
    jp, jloop, tloop = _loops(shift=True, max_iters=8)
    B = 2
    x0 = perturbed_states(jp.initial_state, B, seed=9)
    scheds = [walking_schedule(T, vx=v, start=START, dtype=F64, device="cpu")
              for v in (0.3, 0.1)]
    tsched = TTickInput(*(torch.stack(a, dim=1) for a in zip(*scheds)))
    jsched = JTickInput(*(jnp.asarray(np_of(a)) for a in tsched))
    jc, jo = jit(jloop.run_batch)(jax.vmap(jloop.init)(jnp.asarray(x0)),
                                  jsched)
    tc, to = tloop.run_batch(tloop.init(torch.as_tensor(x0)), tsched)
    assert to.x.shape == (T, B, 37) and to.iterations.shape == (T, B)
    _compare(jo, to)
    assert max_rel_err(tc.sol.X, jc.sol.X) < 1e-9
