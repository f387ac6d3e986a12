"""PyTorch port, the point-feet quadruped's model, problem and gait, in
float64 on the CPU against the JAX package:

  - `models/quadruped.py`'s constants, frames and trot mask equal to the
    JAX package's recorded ones, field by field, exactly;
  - `build_srbd_problem` at `contact_model=1, number_of_legs=4`: sizes,
    declared rows, nominal state, input and parameters equal; the step,
    the residual, equality and terminal stacks to 1e-12 at random points;
    the declared rows covering every nonzero of the autograd Jacobians;
  - the trot WPG (`group_mask=trot_group_mask()`): c_ref, cdot_switch,
    w_ref and the orientation gain equal to JAX's `advance` tick by tick
    over 2·step_nodes ticks of a step command, and over a stance, step and
    jump schedule; the biped with `group_mask=None` unchanged;
  - `build_srbd_loop` with a quadruped `cfg` builds a WPG of that
    topology (the repair: it built the biped's whatever `cfg` said), and
    `build_quadruped_loop` the example's configuration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    QUAD_OPTS,
    QUAD_TOPOLOGY,
    fleet_params,
    jit,
    np_of,
    quadruped_loops,
    quadruped_problems,
    random_xup,
    to_jax,
    to_torch,
)
from srbd_horizon_tpu.models import quadruped as jquad
from srbd_horizon_tpu.wpg import STEP
from srbd_horizon_tpu.wpg import WalkingPatternGenerator as JWPG
from srbd_horizon_tpu_torch.config import DDPOptions, SRBDConfig
from srbd_horizon_tpu_torch.models import quadruped as tquad
from srbd_horizon_tpu_torch.runtime.loop import build_quadruped_loop, build_srbd_loop
from srbd_horizon_tpu_torch.wpg import WalkingPatternGenerator as TWPG

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-12
WPG_KEYS = ("c_ref", "cdot_switch", "w_ref", "orientation_tracking_gain")


@pytest.fixture(scope="module")
def probs():
    return quadruped_problems()


def test_constants_equal_jax():
    got, want = tquad.quadruped_point_feet(), jquad.quadruped_point_feet()
    assert got.mass == want.mass
    for f in ("inertia", "com", "foot_positions"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.foot_frames == want.foot_frames
    assert got.nc == 4
    for name in ("QUADRUPED_FOOT_FRAMES", "QUADRUPED_JOINT_INIT",
                 "QUADRUPED_WORLD_FRAME"):
        assert getattr(tquad, name) == getattr(jquad, name), name
    assert tquad.trot_group_mask() == jquad.trot_group_mask()


def test_problem_equals_jax(probs):
    jp, tp = probs
    assert (tp.ocp.nx, tp.ocp.nu, tp.ocp.ns, tp.nc) == (37, 24, 20, 4)
    for field in ("residual_x_rows", "residual_u_rows", "dynamics_x_rows",
                  "dynamics_u_rows"):
        assert tuple(getattr(tp.ocp, field)) == tuple(getattr(jp.ocp, field))
    for f in ("initial_state", "static_input", "initial_foot_position"):
        np.testing.assert_array_equal(np_of(getattr(tp, f)),
                                      np_of(getattr(jp, f)), err_msg=f)
    assert set(tp.ocp.params) == set(jp.ocp.params)
    for k, v in jp.ocp.params.items():
        np.testing.assert_array_equal(np_of(tp.ocp.params[k]), np_of(v), err_msg=k)
    # point feet: no relative-velocity rows, 57 residual and 12 equality rows
    assert tp.ocp.constants["terms"].n_rho == 69


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fn", ["step", "stage_residual", "stage_eq",
                                "terminal_residual", "terminal_eq", "xdot"])
def test_stacks_match_jax(probs, fn, seed):
    jp, tp = probs
    x, u, p = random_xup(jp.ocp.params, 37, 24, seed, lead=(5,))
    dt = jp.ocp.dt
    jf, tf = getattr(jp.ocp, fn), getattr(tp.ocp, fn)
    if fn == "step":
        want = jax.vmap(lambda a, b, c: jf(a, b, c, dt))(*to_jax((x, u, p)))
        got = tf(to_torch(x), to_torch(u), to_torch(p), dt)
    elif fn.startswith("terminal"):
        want = jax.vmap(jf)(*to_jax((x, p)))
        got = tf(to_torch(x), to_torch(p))
    else:
        want = jax.vmap(jf)(*to_jax((x, u, p)))
        got = tf(to_torch(x), to_torch(u), to_torch(p))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [10, 11])
def test_declared_rows_cover_the_autograd_jacobians(probs, seed):
    """Every nonzero of ∂ρ/∂x, ∂ρ/∂u, A − I and B lies on a declared row
    (what K4 emits and K1 reads), and each declaration prunes something."""
    _, tp = probs
    ocp = tp.ocp
    terms = ocp.constants["terms"]
    wc = float(np.sqrt(DDPOptions().constraint_weight))
    x, u, p = random_xup({k: np_of(v) for k, v in ocp.params.items()},
                         ocp.nx, ocp.nu, seed)
    x, u, p = to_torch(x), to_torch(u), to_torch(p)
    jac = torch.func.jacfwd
    rho = lambda x_, u_: terms.stage_rho(x_, u_, p, wc)
    Jx = jac(lambda x_: rho(x_, u))(x).numpy()
    Ju = jac(lambda u_: rho(x, u_))(u).numpy()
    A = jac(lambda x_: ocp.step(x_, u, p, ocp.dt))(x).numpy() - np.eye(ocp.nx)
    Bm = jac(lambda u_: ocp.step(x, u_, p, ocp.dt))(u).numpy()
    assert Jx.shape[0] == 69
    for J, rows in ((Jx, ocp.residual_x_rows), (Ju, ocp.residual_u_rows),
                    (A, ocp.dynamics_x_rows), (Bm, ocp.dynamics_u_rows)):
        dead = sorted(set(range(J.shape[0])) - set(rows))
        assert dead, "the declaration should prune something"
        assert np.all(J[dead] == 0.0)


def _advance_both(jg, tg, params, actions):
    """Advance both WPGs over `actions` from `params`; yields each tick's
    (torch params, jax params)."""
    jp_, js_ = {k: jnp.asarray(v) for k, v in params.items()}, jg.init_state()
    tp_, ts_ = to_torch(params), tg.init_state()
    jadvance = jit(jg.advance)
    for a in actions:
        jp_, js_ = jadvance(jp_, js_, int(a))
        tp_, ts_ = tg.advance(tp_, ts_, torch.tensor(int(a), dtype=torch.int32))
        yield tp_, jp_


@pytest.mark.parametrize("schedule", ["step", "mixed"])
def test_trot_wpg_matches_jax(probs, schedule):
    """The trot over 2·step_nodes ticks of a step command (both
    half-cycles), and a stance, step and jump mix: every written parameter
    equal to JAX's, tick by tick; lf+rh and rf+lh alternate."""
    jp, _ = probs
    ns = jp.ocp.ns
    jg = JWPG.build(0.0, ns, dtype=jnp.float64, group_mask=jquad.trot_group_mask(),
                    **QUAD_TOPOLOGY)
    tg = TWPG.build(0.0, ns, dtype=F64, group_mask=tquad.trot_group_mask(),
                    device="cpu", **QUAD_TOPOLOGY)
    assert tg.group_mask == jg.group_mask == (True, False, False, True)
    if schedule == "step":
        actions = [STEP] * (2 * tg.step_nodes)
    else:
        actions = [0] * 3 + [1] * 7 + [2] * 2 + [1] * 12 + [0] * 2
    switch = []
    params = {k: np_of(v) for k, v in jp.ocp.params.items()}
    for t, (got, want) in enumerate(_advance_both(jg, tg, params, actions)):
        for k in WPG_KEYS:
            np.testing.assert_array_equal(np_of(got[k]), np.asarray(want[k]),
                                          err_msg=f"{k} at tick {t}")
        switch.append(np_of(got["cdot_switch"])[-1])
    if schedule == "step":
        sw = np.stack(switch)
        np.testing.assert_array_equal(sw[:, 0], sw[:, 3])
        np.testing.assert_array_equal(sw[:, 1], sw[:, 2])
        a, b = np.where(sw[:, 0] == 0.0)[0], np.where(sw[:, 1] == 0.0)[0]
        assert len(a) and len(b) and set(a).isdisjoint(b)


def test_biped_wpg_unchanged_without_a_mask():
    """group_mask=None keeps the biped split (the first contact_model
    contacts in the A-cycle): equal to JAX's default WPG over a walk."""
    from _torch_parity import problems

    jp, _ = problems()
    ns = jp.ocp.ns
    jg = JWPG.build(0.0, ns, dtype=jnp.float64)
    tg = TWPG.build(0.0, ns, dtype=F64, device="cpu")
    assert tg.group_mask is None and jg.group_mask is None
    params = {k: np_of(v) for k, v in jp.ocp.params.items()}
    for t, (got, want) in enumerate(_advance_both(jg, tg, params, [1] * 25)):
        for k in WPG_KEYS:
            np.testing.assert_array_equal(np_of(got[k]), np.asarray(want[k]),
                                          err_msg=f"{k} at tick {t}")


def test_fleet_wpg_takes_the_mask_per_member(probs):
    """A fleet's batched advance with the trot mask equals each member's."""
    jp, _ = probs
    ns = jp.ocp.ns
    tg = TWPG.build(0.0, ns, dtype=F64, group_mask=tquad.trot_group_mask(),
                    device="cpu", **QUAD_TOPOLOGY)
    base = fleet_params(jp.ocp.params, 3)
    fleet, fstate = to_torch(base), tg.init_state((3,))
    one, ostate = to_torch({k: v[0] for k, v in base.items()}), tg.init_state()
    for a in [1] * 7 + [2, 0]:
        fleet, fstate = tg.advance(fleet, fstate,
                                   torch.full((3,), a, dtype=torch.int32))
        one, ostate = tg.advance(one, ostate, torch.tensor(a, dtype=torch.int32))
        for k in WPG_KEYS:
            for m in range(3):
                assert torch.equal(fleet[k][m], one[k]), k


def test_build_srbd_loop_takes_the_topology_of_cfg(probs):
    """The fleet loop's WPG has the contact topology of `cfg`, and the trot
    when given the mask; it advances as JAX's WPG of that topology."""
    jp, _ = probs
    cfg = SRBDConfig(dtype=F64, **QUAD_TOPOLOGY)
    for mask in (None, tquad.trot_group_mask()):
        loop, prob = build_srbd_loop(cfg, DDPOptions(max_iters=1),
                                     robot=tquad.quadruped_point_feet(),
                                     group_mask=mask, device="cpu")
        wpg = loop.wpg
        assert (wpg.contact_model, wpg.number_of_legs) == (1, 4)
        assert wpg.group_mask == mask
        jg = JWPG.build(0.0, jp.ocp.ns, dtype=jnp.float64, group_mask=mask,
                        **QUAD_TOPOLOGY)
        params = {k: np_of(v) for k, v in jp.ocp.params.items()}
        for got, want in _advance_both(jg, wpg, params, [1] * 12):
            for k in WPG_KEYS:
                np.testing.assert_array_equal(np_of(got[k]), np.asarray(want[k]))
    kangaroo, _ = build_srbd_loop(SRBDConfig(dtype=F64), device="cpu")
    assert (kangaroo.wpg.contact_model, kangaroo.wpg.number_of_legs) == (2, 2)
    assert kangaroo.wpg.group_mask is None


def test_build_quadruped_loop_is_the_example(probs):
    jp, _ = probs
    loop, prob = build_quadruped_loop(SRBDConfig(dtype=F64, **QUAD_TOPOLOGY),
                                      device="cpu")
    o = loop.solver.opts
    assert (o.max_iters, o.alpha_converge_threshold, o.beta) == (
        QUAD_OPTS["max_iters"], QUAD_OPTS["alpha_converge_threshold"],
        QUAD_OPTS["beta"])
    assert not loop.shift_warmstart
    assert loop.srbd_constants is prob.ocp.constants
    assert loop.wpg.group_mask == tquad.trot_group_mask()
    assert (loop.wpg.contact_model, loop.wpg.number_of_legs) == (1, 4)
    assert loop.solver.terms.family == "srbd"
    at_feet = TWPG.build(c_init_z=float(np_of(jp.initial_foot_position)[0, 2]),
                         nodes=jp.ocp.ns, dtype=F64, device="cpu")
    assert torch.equal(loop.wpg.l_cycle, at_feet.l_cycle)
    default, _ = build_quadruped_loop(device="cpu")
    assert default.solver.terms.contact_model == 1
    assert default.solver.ocp.params["c_ref"].dtype == torch.float32
    _, jloop, _, _ = quadruped_loops()
    assert jloop.wpg.group_mask == loop.wpg.group_mask
