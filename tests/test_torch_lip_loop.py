"""PyTorch port, the LIP closed loop (the JAX package's dlip example) in
float64 on the CPU:

  - `MPCLoop.run` over 12 ticks of `walking_schedule(vx=0.3, start=3)` with
    the dlip options (`max_iters=100`, `alpha_converge_threshold=1e-12`,
    `beta=1e-3`, the WPG at the feet's height, no SRBD telemetry, no
    warm-start shift) against JAX `run`: iterations and convergence equal
    tick by tick; x and the cost within 1e-9 relative; u0 and the final
    plans within the merit's rounding floor (below); the telemetry
    zeros(6) as in the JAX package;
  - `tick_batch` at B = 2 over 3 ticks (the shifted warm start, a step
    command) against JAX `tick_batch`, within 1e-9;
  - the WPG's advance and the reference shift on LIP params (no w_ref,
    oref or orientation gain to skip over) equal to the JAX package's;
  - `build_lip_loop` on `device="cpu"`: the dlip configuration, and a
    carry crossing from JAX as numpy.

Pushes and the floor: the start is the nominal state pushed by
0.01·N(0, 1). The LIP is linear–quadratic, so each tick's first
Gauss–Newton step is exact and the second iteration runs on the merit's
rounding floor (a predicted reduction of ~1e-15 of the merit), where both
packages converge whatever its line search decides; every tick ends there,
whatever the push. That last step is a rounding-noise gradient through an
ill-conditioned Quu (the 1e6 penalty against μ = 1e-6): it moves the
inputs along directions the cost does not see, by up to 4.7e-8 of max|U|
at this walk's third tick (measured), and whether its α = 1 passes the
Armijo test flips with the order of the sums (there the port took α = ½
and JAX α = 1). So u0 and the plans are held to U_FLOOR = 1e-6 relative,
and `test_u0_differences_are_floor_steps` shows on that tick that the two
packages agree to 1e-12 before the floor step and differ by no more than
their floor steps after it; x (one Euler step of u0) and the cost stay
within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jit, max_rel_err, np_of
from srbd_horizon_tpu.config import DDPOptions as JDDPOptions
from srbd_horizon_tpu.config import SRBDConfig as JSRBDConfig
from srbd_horizon_tpu.models.kangaroo import kangaroo_line_feet as j_feet
from srbd_horizon_tpu.problems.lip import build_lip_problem as j_build
from srbd_horizon_tpu.runtime.loop import MPCLoop as JLoop
from srbd_horizon_tpu.runtime.loop import TickInput as JTickInput
from srbd_horizon_tpu.runtime.loop import walking_schedule as j_walking
from srbd_horizon_tpu.solvers.msddp import MSDDP as JMSDDP
from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG
from srbd_horizon_tpu_torch import build_lip_loop
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.convert import carry_from_numpy, params_from_numpy
from srbd_horizon_tpu_torch.runtime.loop import TickInput as TTickInput
from srbd_horizon_tpu_torch.runtime.loop import walking_schedule
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator as TWPG
from srbd_horizon_tpu_torch.wpg import shift_reference_params

torch.set_num_threads(1)

F64 = torch.float64
T = 12
START = 3
DLIP = dict(max_iters=100, alpha_converge_threshold=1e-12, beta=1e-3)
U_FLOOR = 1e-6      # the floor step's reach in u0 and the plans (docstring)


def _jax_loop(shift=False, **opts):
    jp = j_build(JSRBDConfig(dtype=jnp.float64), j_feet())
    js = JMSDDP(jp.ocp, JDDPOptions(**dict(DLIP, **opts)))
    wpg = JWPG.build(c_init_z=float(jp.initial_foot_position[0, 2]),
                     nodes=jp.ocp.ns, dtype=jnp.float64)
    return jp, JLoop(solver=js, wpg=wpg, shift_warmstart=shift)


def _x0(jp, B=None, seed=41):
    rng = np.random.RandomState(seed)
    x = np.asarray(jp.initial_state)
    if B is None:
        return x + 0.01 * rng.randn(x.shape[0])
    return x[None] + 0.01 * rng.randn(B, x.shape[0])


@pytest.fixture(scope="module")
def walk():
    jp, jloop = _jax_loop()
    tloop, tp = build_lip_loop(SRBDConfig(dtype=F64), device="cpu")
    x0 = _x0(jp)
    jc, jo = jit(jloop.run)(jloop.init(jnp.asarray(x0)),
                            j_walking(T, vx=0.3, start=START,
                                      dtype=jnp.float64))
    sched = walking_schedule(T, vx=0.3, start=START, dtype=F64, device="cpu")
    tc, to = tloop.run(tloop.init(torch.as_tensor(x0)), sched)
    return dict(jp=jp, jloop=jloop, tloop=tloop, tp=tp, x0=x0, jc=jc, jo=jo,
                tc=tc, to=to, sched=sched)


def _compare(jo, to, tol=1e-9):
    np.testing.assert_array_equal(np_of(to.iterations), np.asarray(jo.iterations))
    np.testing.assert_array_equal(np_of(to.converged), np.asarray(jo.converged))
    for f, bound in (("x", tol), ("u0", U_FLOOR), ("cost", tol)):
        got, want = getattr(to, f), getattr(jo, f)
        assert tuple(got.shape) == want.shape, f
        assert max_rel_err(got, want) < bound, f
    np.testing.assert_array_equal(np_of(to.srbd_residual),
                                  np.asarray(jo.srbd_residual))
    np.testing.assert_allclose(np_of(to.defect_norm), np.asarray(jo.defect_norm),
                               rtol=0, atol=1e-12)


def test_run_matches_jax(walk):
    jo, to, jc, tc = walk["jo"], walk["to"], walk["jc"], walk["tc"]
    assert int(walk["sched"].action[-1]) == 1          # the walk ran
    assert int(np_of(to.iterations).min()) >= 2
    _compare(jo, to)
    assert not np.any(np_of(to.srbd_residual))          # no SRBD telemetry
    for f in ("X", "U"):
        assert max_rel_err(getattr(tc.sol, f), getattr(jc.sol, f)) < U_FLOOR, f
    for k in ("c_ref", "cdot_switch", "rdot_ref", "mask_track"):
        np.testing.assert_array_equal(np_of(tc.params[k]), np.asarray(jc.params[k]))
    assert int(tc.wpg_state.step_counter) == T
    assert to.x.shape == (T, 30)


def test_ticks_equal_run(walk):
    """`run` is `tick` over the schedule, output for output."""
    tloop = walk["tloop"]
    carry = tloop.init(torch.as_tensor(walk["x0"]))
    for t in range(T):
        carry, out = tloop.tick(carry, TTickInput(*(a[t] for a in walk["sched"])))
        for f, v in zip(out._fields, out):
            assert torch.equal(v, getattr(walk["to"], f)[t]), (t, f)


def test_u0_differences_are_floor_steps(walk):
    """The walk's third tick, replayed from the carry both packages share
    after two ticks (equal to ~1e-15): one iteration (the exact step) gives
    the same plan to 1e-12; the full solve converges in 2 iterations in
    both, the cost equal to 1e-12, and the plans then differ by no more
    than the two floor steps (each package's last step) together."""
    import dataclasses

    from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

    jloop, tloop = walk["jloop"], walk["tloop"]
    jsched = j_walking(T, vx=0.3, start=START, dtype=jnp.float64)
    jc = jloop.init(jnp.asarray(walk["x0"]))
    tc = tloop.init(torch.as_tensor(walk["x0"]))
    jtick = jit(jloop.tick)
    for t in range(2):
        jc, _ = jtick(jc, jax.tree.map(lambda a: a[t], jsched))
        tc, _ = tloop.tick(tc, TTickInput(*(a[t] for a in walk["sched"])))
    jpar, _ = jloop._pre_solve(jc.params, jc.wpg_state,
                               jax.tree.map(lambda a: a[2], jsched))
    tpar, _ = tloop._pre_solve(tc.params, tc.wpg_state,
                               TTickInput(*(a[2] for a in walk["sched"])))
    sols = {}
    for iters in (1, 100):
        jm = dataclasses.replace(jloop.solver, opts=dataclasses.replace(
            jloop.solver.opts, max_iters=iters))
        tm = MSDDP(tloop.solver.ocp, dataclasses.replace(tloop.solver.opts,
                                                         max_iters=iters))
        sols[iters] = (jit(jm.solve)(jc.sol, jc.x, jpar),
                       tm.solve(tc.sol, tc.x, tpar))
    (j1, t1), (jn, tn) = sols[1], sols[100]
    assert max_rel_err(t1.U, j1.U) < 1e-12
    assert int(tn.iterations) == int(jn.iterations) == 2
    assert bool(tn.converged) and bool(jn.converged)
    assert max_rel_err(tn.cost, jn.cost) < 1e-12
    floor = max_rel_err(jn.U, j1.U) + max_rel_err(tn.U, t1.U)
    assert 0.0 < floor < U_FLOOR
    assert max_rel_err(tn.U, jn.U) <= floor * (1 + 1e-6)


def test_reference_shift_and_advance_on_lip_params(walk):
    """The LIP params carry no w_ref, oref or orientation gain: the shift
    and the WPG's terminal writes skip them, as the JAX package's do."""
    jloop, tloop = walk["jloop"], walk["tloop"]
    from srbd_horizon_tpu.wpg import shift_reference_params as j_shift

    names = ("rdot_ref", "w_ref", "oref", "orientation_tracking_gain")
    rng = np.random.RandomState(5)
    p = {k: rng.randn(*np.shape(v)) for k, v in walk["jp"].ocp.params.items()}
    got = shift_reference_params(params_from_numpy(p, device="cpu", dtype=F64),
                                 names)
    want = j_shift({k: jnp.asarray(v) for k, v in p.items()}, names)
    assert set(got) == set(want) == set(p)
    for k in p:
        np.testing.assert_array_equal(np_of(got[k]), np.asarray(want[k]))
    for action in (0, 1, 2):
        tp_, ts_ = tloop.wpg.advance(
            params_from_numpy(p, device="cpu", dtype=F64),
            tloop.wpg.init_state(), torch.tensor(action, dtype=torch.int32))
        jp_, js_ = jloop.wpg.advance({k: jnp.asarray(v) for k, v in p.items()},
                                     jloop.wpg.init_state(),
                                     jnp.asarray(action, jnp.int32))
        assert set(tp_) == set(jp_)
        for k in tp_:
            np.testing.assert_array_equal(np_of(tp_[k]), np.asarray(jp_[k]))


def test_tick_batch_matches_jax():
    """B = 2 members from pushed states, the shifted warm start, a step
    command at vx 0.3 and 0.1, 3 ticks, `max_iters=30`."""
    jp, jloop = _jax_loop(shift=True, max_iters=30)
    tloop, _ = build_lip_loop(SRBDConfig(dtype=F64),
                              DDPOptions(**dict(DLIP, max_iters=30)),
                              shift_warmstart=True, device="cpu")
    B = 2
    x0 = _x0(jp, B)
    rdot = np.array([[0.3, 0.0, 0.0], [0.1, 0.0, 0.0]])
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
        assert to.x.shape == (B, 30)
        _compare(jo, to)
    assert max_rel_err(tc.sol.X, jc.sol.X) < 1e-9


def test_build_lip_loop_on_cpu(walk):
    """The dlip configuration, and a JAX carry crossing to the port as
    numpy: both packages take two more ticks from it."""
    tloop, tp = walk["tloop"], walk["tp"]
    o = tloop.solver.opts
    assert (o.max_iters, o.alpha_converge_threshold, o.beta) == (100, 1e-12, 1e-3)
    assert tloop.srbd_constants is None and not tloop.shift_warmstart
    assert tloop.solver.terms.family == "lip"
    assert tp.ocp.constants["terms"] is tloop.solver.terms
    at_feet = TWPG.build(c_init_z=float(tp.initial_foot_position[0, 2]),
                         nodes=tp.ocp.ns, dtype=F64, device="cpu")
    assert torch.equal(tloop.wpg.l_cycle, at_feet.l_cycle)
    if not torch.cuda.is_available():         # "cuda" is the default device
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_lip_loop()
    jloop, jc = walk["jloop"], walk["jc"]
    tc = carry_from_numpy(
        np.asarray(jc.x), {f: np.asarray(v) for f, v in jc.sol._asdict().items()},
        {k: np.asarray(v) for k, v in jc.params.items()},
        np.asarray(jc.wpg_state.step_counter), device="cpu", dtype=F64)
    jtick = jit(jloop.tick)
    for _ in range(2):
        jc, jo = jtick(jc, jax.tree.map(lambda a: a[-1],
                                        j_walking(T, vx=0.3, start=START,
                                                  dtype=jnp.float64)))
        tc, to = tloop.tick(tc, TTickInput(*(a[-1] for a in walk["sched"])))
        np.testing.assert_array_equal(np_of(to.iterations), np.asarray(jo.iterations))
        assert max_rel_err(to.x, jo.x) < 1e-9
