"""PyTorch port, the point-feet biped (`point_feet()`, `SRBDConfig(
contact_model=1, number_of_legs=2)`: nc=2, nx=25, nu=12, 39 residual rows,
6 equality rows), against the JAX package on the CPU in float64:

  - `point_feet()` equal to JAX's; the problem's sizes, declared row sets,
    x0, u0 and parameters equal, its step, residual, equality and terminal
    stacks to 1e-12 at drawn points, and its declared rows complete
    (`torch.func.jacfwd`);
  - the twins of the kernels at `srbd::PointFeetShape`: K4's against JAX's
    sliced linearization (jacfwd over the declared rows) to 1e-12, K3's
    (rollout, cost, Armijo test at 1 and 4 step sizes, a member from a
    NaN state rejected) and srbd_evaluate's (without and with the node-0
    pin, a NaN plan NaN) against JAX's to 1e-12, K1's collapsed form
    against `_backward_lanemajor` and its Tassa form (both gain solves)
    against `_backward` to 1e-9;
  - `MSDDP.solve` and `solve_batch` against JAX's `solve` and
    `vmap(solve)` at ns=8: iterations equal, X and U to 1e-9;
  - `MPCLoop.run` for 8 ticks of the dsrbd walk and `tick_batch` for 3
    ticks at B=4 against JAX's `run` and `vmap(tick)`;
  - the two other execution modes build here (K12 and K13 have its
    shape; tests/test_torch_modes_point_feet.py holds them to JAX).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    agree, check_srbd_solves, check_srbd_ticks, fleet_params, jax_evaluate,
    jax_trial, jit, max_rel_err, np_of, perturbed_states, random_xup,
    run_results, six_contact_srbd, solvers, srbd_case, srbd_problems, to_jax,
    to_torch, trajectories,
)
from srbd_horizon_tpu.models.kangaroo import point_feet as j_point_feet
from srbd_horizon_tpu_torch.kernels import linearize as k4
from srbd_horizon_tpu_torch.kernels import riccati as k1
from srbd_horizon_tpu_torch.kernels import rollout as k3
from srbd_horizon_tpu_torch.models.kangaroo import point_feet

torch.set_num_threads(1)

ORDER = ("Sx", "Bs", "Jxp", "Jup", "rho", "d", "Jt", "rt")
TOL = 1e-12
MU = 1e-6
B = 4
NAN_MEMBER = 1
ALPHAS = np.array([1.0, 0.5, 0.25, 0.125])


@pytest.fixture(scope="module")
def probs():
    return srbd_problems("point_feet")


@pytest.mark.parametrize("legs", [2, 3, 4])
def test_point_feet_matches_jax(legs):
    got, want = point_feet(legs), j_point_feet(legs)
    assert got.mass == want.mass and got.foot_frames == want.foot_frames
    for key in ("inertia", "com", "foot_positions"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))


def test_problem_sizes_rows_and_start(probs):
    jp, tp = probs
    ocp = tp.ocp
    assert (ocp.nx, ocp.nu, tp.nc) == (25, 12, 2)
    assert ocp.constants["terms"].n_rho == 45
    assert len(ocp.residual_u_rows) == 24 and len(ocp.residual_x_rows) == 24
    assert (len(ocp.dynamics_x_rows), len(ocp.dynamics_u_rows)) == (16, 12)
    for field in ("residual_x_rows", "residual_u_rows", "dynamics_x_rows",
                  "dynamics_u_rows"):
        assert tuple(getattr(ocp, field)) == tuple(getattr(jp.ocp, field))
    np.testing.assert_array_equal(np_of(tp.initial_state),
                                  np_of(jp.initial_state))
    np.testing.assert_array_equal(np_of(tp.static_input),
                                  np_of(jp.static_input))
    for k, v in jp.ocp.params.items():
        np.testing.assert_array_equal(np_of(ocp.params[k]), np_of(v), err_msg=k)


@pytest.mark.parametrize("fn", ["step", "xdot", "stage_residual", "stage_eq",
                                "terminal_residual", "terminal_eq"])
def test_stacks_match_jax(probs, fn):
    jp, tp = probs
    x, u, p = random_xup(jp.ocp.params, 25, 12, seed=21, lead=(5,))
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
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_declared_rows_complete(probs):
    """Outside the declared rows the residual Jacobians, A − I and B are
    zero at a drawn point (`torch.func.jacfwd`)."""
    jp, tp = probs
    _, ts = solvers(jp, tp)
    ocp = tp.ocp
    x, u, p = (to_torch(a) for a in random_xup(jp.ocp.params, 25, 12, seed=22))
    jac = torch.func.jacfwd
    Jx = jac(lambda x_: ts._stage_rho(x_, u, p))(x).numpy()
    Ju = jac(lambda u_: ts._stage_rho(x, u_, p))(u).numpy()
    A = jac(lambda x_: ocp.step(x_, u, p, ocp.dt))(x).numpy() - np.eye(25)
    Bm = jac(lambda u_: ocp.step(x, u_, p, ocp.dt))(u).numpy()
    for J, rows in ((Jx, ocp.residual_x_rows), (Ju, ocp.residual_u_rows),
                    (A, ocp.dynamics_x_rows), (Bm, ocp.dynamics_u_rows)):
        dead = sorted(set(range(J.shape[0])) - set(rows))
        assert dead and np.all(J[dead] == 0.0)


@pytest.fixture(scope="module")
def case(probs):
    """A point near the walk: plans around the nominal state, random
    references and 0/1 switches; JAX's sliced linearization and collapsed
    sweep of it, and the K4 twin's."""
    jp, tp = probs
    js, ts = solvers(jp, tp)
    X, U = trajectories(jp, B, seed=23)
    params = fleet_params(jp.ocp.params, B)
    rng = np.random.RandomState(24)
    params["rdot_ref"] = 0.3 * rng.randn(*params["rdot_ref"].shape)
    params["cdot_switch"] = rng.randint(0, 2, params["cdot_switch"].shape) * 1.0
    params["mask_track"] = rng.randint(0, 2, params["mask_track"].shape) * 1.0
    jlin = jit(jax.vmap(
        lambda x, u, p: js._linearize(x, u, p, sliced=True)))(
            *to_jax((X, U, params)))
    jback = jit(js._backward_lanemajor)(jlin, jnp.asarray(MU))
    tlin = k4.srbd_linearize_plain(to_torch(X), to_torch(U), to_torch(params),
                                   ts.terms, ts.rows, tp.ocp.dt,
                                   ts._wc(torch.float64))
    x0 = perturbed_states(jp.initial_state, B, seed=25)
    return dict(jp=jp, tp=tp, js=js, ts=ts, X=X, U=U, params=params,
                jlin=jlin, jback=jback, tlin=tlin, x0=x0)


@pytest.mark.parametrize("key", ORDER)
def test_linearize_twin_matches_jax(case, key):
    got, want = case["tlin"][key], case["jlin"][key]
    assert tuple(got.shape) == tuple(want.shape)
    assert max_rel_err(got, want) < TOL


@pytest.mark.parametrize("nA", [1, 4])
def test_trial_twin_matches_jax(case, nA):
    """The K3 twin against JAX's trial (`jax_trial`) on the case's plan,
    gains and defects; member 1 starts from a NaN state and is
    rejected."""
    js, ts = case["js"], case["ts"]
    opts = js.opts
    ks, Ks, dV1, dV2 = case["jback"]
    d = case["jlin"]["d"]
    x0 = np.array(case["x0"])
    x0[NAN_MEMBER] = np.nan
    want, merit0, D = jax_trial(js, x0, case["X"], case["U"], case["params"],
                                ks, Ks, d, dV1, dV2, ALPHAS[:nA])
    t = lambda a: to_torch(np_of(a))
    got = k3.srbd_trial_plain(
        t(x0), to_torch(case["X"]), to_torch(case["U"]), t(ks), t(Ks), t(d),
        to_torch(ALPHAS[:nA]), to_torch(case["params"]), t(merit0), t(D),
        t(dV1), t(dV2), ts.terms, ts.ocp.dt, ts._wc(torch.float64),
        opts.defect_weight, opts.beta, opts.alpha_converge_threshold)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert not bool(got[4][:, NAN_MEMBER].any())


@pytest.mark.parametrize("pin", [False, True], ids=["plan", "pinned"])
def test_evaluate_twin_matches_jax(case, pin):
    js, ts = case["js"], case["ts"]
    X = np.array(case["X"])
    X[NAN_MEMBER, 5, 4] = np.nan
    x0 = case["x0"] if pin else None
    Xj = X.copy()
    if pin:
        Xj[:, 0] = x0

    want = jax_evaluate(js, Xj, case["U"], case["params"])
    got = k3.srbd_evaluate_plain(
        to_torch(X), to_torch(case["U"]), to_torch(case["params"]), ts.terms,
        case["tp"].ocp.dt, ts._wc(torch.float64),
        None if x0 is None else to_torch(x0))
    for g, w in zip(got[:2], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
        assert np.isnan(g.numpy()[NAN_MEMBER])
    if pin:
        np.testing.assert_array_equal(got[2].numpy(), Xj)


def test_collapsed_sweep_twin_matches_jax(case):
    got = k1.riccati_backward_plain(*(case["tlin"][k] for k in ORDER), MU,
                                    case["ts"].rows)
    for g, w in zip(got, case["jback"]):
        assert max_rel_err(g, w) < 1e-9


@pytest.mark.parametrize("solver", ["schur", "cholesky"])
def test_tassa_sweep_twin_matches_jax(case, solver):
    """`MSDDP.solve`'s sweep: JAX's unbatched `_backward` on its dense
    linearization of member 0, with the gain solve `solver`."""
    js, ts = case["js"], case["ts"]
    jm = dataclasses.replace(js, opts=dataclasses.replace(js.opts,
                                                         quu_solver=solver))
    p = {k: v[0] for k, v in case["params"].items()}
    jlin = jit(jm._linearize)(jnp.asarray(case["X"][0]),
                              jnp.asarray(case["U"][0]), to_jax(p))
    want = jit(jm._backward)(jlin, jnp.asarray(MU))
    tlin = {k: v[:1] for k, v in case["tlin"].items()}
    got = k1.riccati_backward_plain(*(tlin[k] for k in ORDER), MU, ts.rows,
                                    form="tassa", quu_solver=solver)
    for g, w in zip(got, want):
        assert max_rel_err(g[0], w) < 1e-9


def test_shapes_pass_the_cuda_checks(case):
    ts, tp = case["ts"], case["tp"]
    ocp = tp.ocp
    assert k4.check_kernel_shape("srbd_linearize", ts.terms, ocp.nx, ocp.nu,
                                 ts.rows) == "point_feet"
    nt = case["tlin"]["Jt"].shape[1]
    assert k1.kernel_shape(ocp.nx, ocp.nu, nt, ts.rows) == "point_feet"


@pytest.fixture(scope="module")
def solves():
    """`solve`, `solve_batch` and 3 `tick_batch` ticks beside JAX's `solve`,
    `vmap(solve)`, `solve_batch` and `vmap(tick)`, one JAX compile."""
    return srbd_case("point_feet", "EULER", kernels=False,
                     jax_solve_batch=True)


def test_solve_matches_jax(solves):
    check_srbd_solves(solves, batched=False)


def test_solve_batch_matches_vmap_solve(solves):
    check_srbd_solves(solves, batched=True)
    # under Euler JAX's batched path agrees with its vmap(solve)
    j = solves["jax"]
    agree(j["solve_batch"], j["vmap_solve"], "jax solve_batch", ("X", "U"))


def test_run_matches_jax():
    """The dsrbd walk (vx 0.3 from tick 2) for 8 ticks of `run`."""
    (tc, to), (jc, jo) = run_results("point_feet", "EULER")
    agree(to, jo, "run", ("x", "u0", "cost"))
    for f in ("X", "U"):
        assert max_rel_err(getattr(tc.sol, f), getattr(jc.sol, f)) < 1e-9, f
    assert float(to.defect_norm.max()) < 1e-6
    assert float(to.srbd_residual.abs().max()) < 1e-6


def test_tick_batch_matches_vmap_tick(solves):
    check_srbd_ticks(solves)


@pytest.mark.parametrize("mode", [("associative", "nonlinear"),
                                  ("sequential", "linear")],
                         ids=["associative", "linear"])
def test_modes_are_refused(probs, mode):
    """K12 and K13 now have a kernel at the point-feet shape: `MSDDP` builds
    the two other execution modes there (K13's point-feet family, K12's
    `point_feet` instantiation), and refuses them, on every device and
    naming ROADMAP.md, only where no kernel is compiled: the SRBD problem
    at contact_model=3."""
    from srbd_horizon_tpu_torch.config import DDPOptions
    from srbd_horizon_tpu_torch.kernels import linear_trial as k13
    from srbd_horizon_tpu_torch.kernels import riccati_associative as k12
    from srbd_horizon_tpu_torch.solvers.msddp import MSDDP

    opts = DDPOptions(max_iters=2, riccati_mode=mode[0], forward_pass=mode[1])
    s = MSDDP(probs[1].ocp, opts)
    ocp = probs[1].ocp
    assert k13.family_index(s.terms, ocp.nx, ocp.nu, s.rows) == 5
    assert k12.shape_instance("point_feet", opts.quu_solver) == 8
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        MSDDP(six_contact_srbd().ocp, opts)
